"""The per-round training loop (port of ``lidal_tpu/runtime/train_loop.py``,
SemanticKITTI and nuScenes, one device or data parallel over a process group;
reference ``train.py:17-203``).

Mode selection (reference train.py:89-109):
  r_id == 0            -> 1% random fully-labeled frames ('train_frame')
  metric == 'full'     -> whole train split
  label_unit == 'fr'   -> frames flagged by the current round's metric
  label_unit == 'sv'   -> frames with labeled supervoxels, labels masked per-point

Loop: epochs over the loader until step >= max_iter; checkpoint every
``ckpt_every`` steps and at the end (reference train.py:114-158).  One step
is one Python iteration: upload the batch, prepare it on the device, then
``runtime/train.train_step``; each part is a span of ``utils.profiling``
(``train.upload``, ``train.prepare_batch``, ``train.step``, and
``train.log`` / ``train.checkpoint`` on the steps that log or save).

Data parallel (``group``, reference ``train.py:26-53``): the global batch is
``batch_size`` frames per rank; rank r reads and prepares rows
``[r * b, (r + 1) * b)`` of every global batch, augmented with its rows of
the global batch's draws, and the parameters start from rank 0's.  Files are
written by rank 0 alone, behind a barrier.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from lidal_tpu_torch.config import RunConfig, is_ptv3
from lidal_tpu_torch.runtime.paths import Paths, ensure_dir
from lidal_tpu_torch.data import nuscenes as nu, semantic_kitti as sk
from lidal_tpu_torch.data.augment import sample_augment
from lidal_tpu_torch.data.loader import FrameBatchLoader
from lidal_tpu_torch.data.pipeline import prepare_train_batch
from lidal_tpu_torch.data.selection import (
    apply_sv_label_mask,
    bootstrap_round0,
    frame_flags_for_round,
    frame_name,
    load_sv_info,
    sv_training_set,
    train_files_frame_level,
)
from lidal_tpu_torch.models.layers import sync_batchnorm
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.ptv3 import PTv3, StepDraws
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.parallel import mesh
from lidal_tpu_torch.runtime import checkpoint as ckpt
from lidal_tpu_torch.runtime.train import TrainState, flat_buckets, make_optimizer, train_step
from lidal_tpu_torch.utils import profiling


def build_model(cfg: RunConfig, group: Optional[dist.ProcessGroup] = None) -> torch.nn.Module:
    """The model family ``cfg.model_name`` names (SPVCNN is a MinkUNet trunk
    with a point branch; PTv3 is Point Transformer V3); with ``group`` every
    BN, SPVCNN's point-branch BNs included, sums its train-mode statistics
    over the group."""
    cls = PTv3 if is_ptv3(cfg) else SPVCNN if cfg.is_spvcnn else MinkUNet
    return sync_batchnorm(cls(num_classes=cfg.data.num_classes), group)


def step_draws(gen: torch.Generator, cfg: RunConfig, n_global: int, lo: int, hi: int):
    """A step's draws of the model's own randomness, after the augmentation's:
    SPVCNN's dropout seeds, one per frame, so a frame's masks do not depend
    on its batch mates (``models/layers.PerFrameDropout``); PTv3's the same
    for its drop path and one more seed for the step's order shuffle
    (``models/ptv3.StepDraws``); a rank keeps its rows.  None for MinkUNet."""
    if not (cfg.is_spvcnn or is_ptv3(cfg)):
        return None
    seeds = torch.randint(0, 2**62, (n_global,), generator=gen)[lo:hi].tolist()
    if cfg.is_spvcnn:
        return seeds
    return StepDraws(seeds, int(torch.randint(0, 2**62, (1,), generator=gen)))


def _bootstrap_round0(cfg: RunConfig, seq_frames: dict, group: Optional[dist.ProcessGroup]) -> None:
    """The round-0 flag trees, written by rank 0 while the others wait."""
    if mesh.rank(group) == 0:
        bootstrap_round0(cfg, seq_frames)
    mesh.sync_hosts("bootstrap", group)


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


def nu_seq_frames(cfg: RunConfig) -> dict:
    """scene -> frame entries of the train split for nuScenes (manifest-based;
    see data/nuscenes.py).  Frame 'paths' are manifest entries keyed by token."""
    manifest = nu.build_manifest(cfg.nu_root, cache_path=f"{cfg.processing_root}/NU/manifest.pkl")
    train, _ = nu.load_splits(list(manifest), f"{cfg.nu_root}/splits.json")
    return {s: manifest[s] for s in train}


def frame_flags_for_round_generic(cfg: RunConfig, split, seq_frames) -> np.ndarray:
    """Frame flags concatenated over a split; all False where the round's
    flag files are missing."""
    try:
        return frame_flags_for_round(cfg, split)
    except FileNotFoundError:
        return np.zeros(sum(len(seq_frames[s]) for s in split), bool)


def _build_nu_train_loader(cfg: RunConfig, shuffle: bool = True,
                           group: Optional[dist.ProcessGroup] = None) -> FrameBatchLoader:
    """nuScenes loaders: the same flag trees keyed by scene name; frame 'files'
    are manifest entries (dicts), named by token (nu_dataloader.py:294-319)."""
    data = cfg.data
    seq_frames = nu_seq_frames(cfg)
    split = sorted(seq_frames)
    all_entries = [e for s in split for e in seq_frames[s]]

    def read_fn(e):
        return nu.read_frame(e, with_labels=True)

    if cfg.r_id == 0:
        _bootstrap_round0(cfg, seq_frames, group)
        flags = frame_flags_for_round_generic(cfg, split, seq_frames)
        entries = [e for e, keep in zip(all_entries, flags) if keep]
    elif cfg.metric_name == "full":
        entries = all_entries
    elif cfg.label_unit == "fr":
        flags = frame_flags_for_round_generic(cfg, split, seq_frames)
        entries = [e for e, keep in zip(all_entries, flags) if keep]
    else:  # sv: frames with labeled supervoxels, labels masked per point
        entries, svf, svi, pse = sv_training_set(cfg, seq_frames)
        svf_by = dict(zip(map(frame_name, entries), svf))
        svi_by = dict(zip(map(frame_name, entries), svi))
        pse_by = dict(zip(map(frame_name, entries), pse)) if pse else None

        def read_fn(e):  # noqa: F811
            xyz, sig, labels = nu.read_frame(e, with_labels=True)
            name = frame_name(e)
            point2sv, _ = load_sv_info(svi_by[name])
            pseudo = np.load(pse_by[name]) if pse_by is not None else None
            return xyz, sig, apply_sv_label_mask(labels, point2sv, np.load(svf_by[name]), pseudo)

    print(f"Train_{cfg.r_id}r samples:", len(entries))
    return FrameBatchLoader(
        entries,
        read_fn,
        point_cap=data.point_cap,
        batch_size=data.batch_size * mesh.world(group),
        shuffle=shuffle,
        seed=cfg.seed,
    )


def build_train_loader(cfg: RunConfig, shuffle: bool = True,
                       group: Optional[dist.ProcessGroup] = None) -> FrameBatchLoader:
    """The round's training loader; its batch is ``batch_size`` frames per
    rank of ``group`` (the global batch).  Round 0 first writes its flag
    trees (rank 0, behind a barrier)."""
    if cfg.dataset_name == "NU":
        return _build_nu_train_loader(cfg, shuffle, group)
    data = cfg.data
    seq_frames = {s: sk.list_frames(cfg.data_root, [s]) for s in data.train_split}
    all_files = [f for s in data.train_split for f in seq_frames[s]]

    read_fn = make_sk_read_fn(cfg)
    if cfg.r_id == 0:
        _bootstrap_round0(cfg, seq_frames, group)
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
        batch_size=data.batch_size * mesh.world(group),
        shuffle=shuffle,
        seed=cfg.seed,
    )


def init_state(cfg: RunConfig, device: torch.device, group: Optional[dist.ProcessGroup] = None) -> TrainState:
    """A fresh model (its BNs synced over ``group``) and Adam, the weights
    drawn from ``cfg.seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg, group)
    model = model.to(device)
    return TrainState(step=0, model=model, optimizer=make_optimizer(model))


def broadcast_model(model: torch.nn.Module, group: Optional[dist.ProcessGroup]) -> None:
    """Rank 0's parameters and buffers onto every rank of ``group``, one
    broadcast per flat bucket (nothing without a group)."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for bucket in flat_buckets(list(model.parameters()) + list(model.buffers())):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.broadcast(flat, src, group=group)
            for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(part.view_as(t))


def run_train(
    cfg: RunConfig,
    loader: Optional[FrameBatchLoader] = None,
    max_iter: Optional[int] = None,
    log_every: int = 50,
    on_step: Optional[Callable] = None,
    *,
    device: Union[torch.device, str] = "cuda",
    group: Optional[dist.ProcessGroup] = None,
) -> TrainState:
    """Train one round on ``device``; returns the final :class:`TrainState`.

    The batch is ``cfg.data.batch_size`` frames per rank of ``group`` (one
    rank without it), as the reference's per-GPU batch under DDP
    (``sk_dataloader.py:21,39-42``).  A caller's ``loader`` yields global
    batches, which the ranks must split evenly.  Augmentation and SPVCNN's per-frame dropout seeds draw
    from a CPU ``torch.Generator`` seeded from ``cfg.seed``, for the global
    batch (PTv3: its drop-path seeds and order shuffle, ``step_draws``).
    ``on_step(step, loss)`` gets the loss as a device tensor; the log
    line reads it every ``log_every`` steps."""
    device = torch.device(device)
    data = cfg.data
    paths = Paths(cfg)
    ensure_dir(paths.ckpt_dir())
    loader = loader or build_train_loader(cfg, group=group)
    assert len(loader.files) > 0, "empty training set"
    max_iter = max_iter if max_iter is not None else cfg.max_iter
    n_global, n_ranks = loader.batch_size, mesh.world(group)
    if n_global % n_ranks:
        raise ValueError(f"a train batch of {n_global} frames does not split over {n_ranks} ranks")
    rows = mesh.process_shard(n_global, group)
    lo, hi = rows.start, rows.stop
    if n_ranks > 1:
        loader = loader.with_rows(lo, hi)
    lead = mesh.rank(group) == 0

    state, ep_id = ckpt.resume_or_warm_start(paths, init_state(cfg, device, group))
    broadcast_model(state.model, group)
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
        with profiling.span("train.upload"):
            arrays = [torch.as_tensor(b[k]).to(device, non_blocking=True) for k in ("xyz", "sig", "valid", "labels")]
        with profiling.span("train.prepare_batch"):
            draws = sample_augment(gen, n_global)
            tb = prepare_train_batch(
                None,
                *arrays,
                level_caps=data.level_caps,
                scale=data.scale,
                full_scale=data.full_scale,
                draws=draws.rows(lo, hi),
                with_points=cfg.is_spvcnn,
            )
            seeds = step_draws(gen, cfg, n_global, lo, hi)
        loss = train_step(state, tb, seeds, group)
        if b.get("trunc_points", 0):
            print(f"WARNING: point_cap truncated {b['trunc_points']} points this batch")
        step = state.step
        if on_step is not None:
            on_step(step, loss)
        if step % log_every == 0:
            with profiling.span("train.log"):
                ovf = mesh.all_reduce_(tb.overflow.sum(), group)
                if lead:
                    ovf = int(ovf)
                    extra = f" voxel_overflow: {ovf}" if ovf else ""
                    print(f"Iteration: {step} loss: {float(loss):.4f}{extra}")
        if step % cfg.ckpt_every == 0 and lead:
            with profiling.span("train.checkpoint"):
                ckpt.save_checkpoint(paths.ckpt_dir(), state, ep_id)
    if lead:
        ckpt.save_checkpoint(paths.ckpt_dir(), state, ep_id)
    mesh.sync_hosts("train", group)
    return state
