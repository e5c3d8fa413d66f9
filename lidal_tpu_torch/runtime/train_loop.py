"""The per-round training loop (port of ``lidal_tpu/runtime/train_loop.py``,
SemanticKITTI, single device; reference ``train.py:17-203``).

Mode selection (reference train.py:89-109):
  r_id == 0            -> 1% random fully-labeled frames ('train_frame')
  metric == 'full'     -> whole train split
  label_unit == 'fr'   -> frames flagged by the current round's metric
  label_unit == 'sv'   -> frames with labeled supervoxels, labels masked per-point

Loop: epochs over the loader until step >= max_iter; checkpoint every
``ckpt_every`` steps and at the end (reference train.py:114-158).  One step
is one Python iteration: prepare the batch on the device, then
``runtime/train.train_step``.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.runtime.paths import Paths, ensure_dir
from lidal_tpu_torch.data import semantic_kitti as sk
from lidal_tpu_torch.data.loader import FrameBatchLoader
from lidal_tpu_torch.data.pipeline import prepare_train_batch
from lidal_tpu_torch.data.selection import (
    apply_sv_label_mask,
    bootstrap_round0,
    load_sv_info,
    sv_training_set,
    train_files_frame_level,
)
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.runtime import checkpoint as ckpt
from lidal_tpu_torch.runtime.train import TrainState, make_optimizer, train_step


def build_model(cfg: RunConfig) -> MinkUNet:
    """The model family ``cfg.model_name`` names (SPVCNN is a MinkUNet trunk
    with a point branch)."""
    cls = SPVCNN if cfg.is_spvcnn else MinkUNet
    return cls(num_classes=cfg.data.num_classes)


def make_sk_read_fn(cfg: RunConfig, sv_flag_by_frame=None, sv_info_by_frame=None, pseudo_by_frame=None):
    """Reader closure implementing the reference's per-mode label handling."""

    def read(path):
        xyz, sig, labels = sk.read_frame(path, with_labels=True)
        if sv_flag_by_frame is not None:
            flags = np.load(sv_flag_by_frame[path])
            point2sv, _ = load_sv_info(sv_info_by_frame[path])
            pseudo = None
            if pseudo_by_frame is not None:
                pseudo = np.load(pseudo_by_frame[path])
            labels = apply_sv_label_mask(labels, point2sv, flags, pseudo)
        return xyz, sig, labels

    return read


def build_train_loader(cfg: RunConfig, shuffle: bool = True) -> FrameBatchLoader:
    if cfg.dataset_name != "SK":
        raise NotImplementedError("the port's train loader reads SemanticKITTI; nuScenes is not ported yet")
    data = cfg.data
    seq_frames = {s: sk.list_frames(cfg.data_root, [s]) for s in data.train_split}
    all_files = [f for s in data.train_split for f in seq_frames[s]]

    read_fn = make_sk_read_fn(cfg)
    if cfg.r_id == 0:
        bootstrap_round0(cfg, seq_frames)
        files = train_files_frame_level(cfg, all_files, data.train_split)
    elif cfg.metric_name == "full":
        files = all_files
    elif cfg.label_unit == "fr":
        files = train_files_frame_level(cfg, all_files, data.train_split)
    else:  # sv
        files, svf, svi, pse = sv_training_set(cfg, seq_frames)
        read_fn = make_sk_read_fn(
            cfg,
            sv_flag_by_frame=dict(zip(files, svf)),
            sv_info_by_frame=dict(zip(files, svi)),
            pseudo_by_frame=dict(zip(files, pse)) if pse else None,
        )
    print(f"Train_{cfg.r_id}r samples:", len(files))
    return FrameBatchLoader(
        files,
        read_fn,
        point_cap=data.point_cap,
        batch_size=data.batch_size,
        shuffle=shuffle,
        seed=cfg.seed,
    )


def init_state(cfg: RunConfig, device: torch.device) -> TrainState:
    """A fresh model and Adam, the weights drawn from ``cfg.seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg)
    model = model.to(device)
    return TrainState(step=0, model=model, optimizer=make_optimizer(model))


def run_train(
    cfg: RunConfig,
    loader: Optional[FrameBatchLoader] = None,
    max_iter: Optional[int] = None,
    log_every: int = 50,
    on_step: Optional[Callable] = None,
    *,
    device: Union[torch.device, str] = "cuda",
) -> TrainState:
    """Train one round on ``device``; returns the final :class:`TrainState`.

    The batch is ``cfg.data.batch_size`` frames.  Augmentation and SPVCNN's
    per-frame dropout seeds draw from a CPU ``torch.Generator`` seeded from
    ``cfg.seed``.  ``on_step(step, loss)`` gets the loss as a device tensor;
    the log line reads it every ``log_every`` steps."""
    device = torch.device(device)
    data = cfg.data
    paths = Paths(cfg)
    ensure_dir(paths.ckpt_dir())
    loader = loader or build_train_loader(cfg)
    assert len(loader.files) > 0, "empty training set"
    max_iter = max_iter if max_iter is not None else cfg.max_iter

    state, ep_id = ckpt.resume_or_warm_start(paths, init_state(cfg, device))
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed)

    def batches():
        nonlocal ep_id
        while True:
            loader.set_epoch(ep_id)
            yielded = False
            for b in loader:
                yielded = True
                yield b
            ep_id += 1
            if not yielded:
                return

    stream = batches()
    while state.step < max_iter:
        b = next(stream, None)
        if b is None:
            break
        tb = prepare_train_batch(
            gen,
            *(torch.as_tensor(b[k]).to(device, non_blocking=True) for k in ("xyz", "sig", "valid", "labels")),
            level_caps=data.level_caps,
            scale=data.scale,
            full_scale=data.full_scale,
            with_points=cfg.is_spvcnn,
        )
        # SPVCNN's dropout: one seed per frame, so a frame's masks do not
        # depend on its batch mates (models/layers.PerFrameDropout)
        seeds = torch.randint(0, 2**62, (len(tb.feats),), generator=gen).tolist() if cfg.is_spvcnn else None
        loss = train_step(state, tb, seeds)
        if b.get("trunc_points", 0):
            print(f"WARNING: point_cap truncated {b['trunc_points']} points this batch")
        step = state.step
        if on_step is not None:
            on_step(step, loss)
        if step % log_every == 0:
            ovf = int(tb.overflow.sum())
            extra = f" voxel_overflow: {ovf}" if ovf else ""
            print(f"Iteration: {step} loss: {float(loss):.4f}{extra}")
        if step % cfg.ckpt_every == 0:
            ckpt.save_checkpoint(paths.ckpt_dir(), state, ep_id)
    ckpt.save_checkpoint(paths.ckpt_dir(), state, ep_id)
    return state
