"""Command implementations wiring the run loops, data and checkpoints (port of
``lidal_tpu/cli/commands.py``: SemanticKITTI and nuScenes, MinkUNet, SPVCNN or PTv3,
every selection metric, every ``prep`` stage, ``import-torch``).

Every command that runs a model runs it on ``device`` (default: the CUDA card)
and builds the model family ``cfg.model_name`` names
(``runtime/train_loop.build_model``); ``prep`` is host code.

Under a process group (``group``: the command line under ``torchrun``,
``parallel/mesh.init_from_env``) evaluation and the LiDAL rounds run over its
ranks, inference takes this rank's contiguous share of the frames, and the
other selection metrics run on rank 0 while the other ranks wait.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.parallel import mesh
from lidal_tpu_torch.runtime.paths import Paths

Device = Union[torch.device, str]
Group = Optional[dist.ProcessGroup]


def _load_eval_variables(cfg: RunConfig, device: Device = "cuda") -> torch.nn.Module:
    """Build the model and restore the round checkpoint (``current_port.pt``)
    for inference (reference evaluate.py:56-71, prob_inference.py:60-75).
    Returns the model on ``device`` in eval mode."""
    from lidal_tpu_torch.runtime import checkpoint as ckpt
    from lidal_tpu_torch.runtime.train_loop import init_state

    state = init_state(cfg, torch.device(device))
    paths = Paths(cfg)
    if ckpt.restore_checkpoint(paths.ckpt_dir(), state) is None:
        raise FileNotFoundError(f"no checkpoint under {paths.ckpt_dir()}")
    print(f"Restored from: {ckpt.ckpt_path(paths.ckpt_dir())}")
    return state.model.eval()


def _dataset_frames(cfg: RunConfig, split: str):
    """(files, read_fn, frame_id_fn) for the requested split ('train'|'val')."""
    if cfg.dataset_name == "SK":
        from lidal_tpu_torch.data import semantic_kitti as sk

        data = cfg.data
        seqs = data.train_split if split == "train" else data.val_split
        return sk.list_frames(cfg.data_root, seqs), sk.read_frame, sk.frame_id

    from lidal_tpu_torch.data import nuscenes as nu

    manifest = nu.build_manifest(cfg.nu_root, cache_path=f"{cfg.processing_root}/NU/manifest.pkl")
    train, val = nu.load_splits(list(manifest), f"{cfg.nu_root}/splits.json")
    scenes = train if split == "train" else val
    files = [e | {"scene": s} for s in scenes for e in manifest[s]]

    def read(e, with_labels=True):
        return nu.read_frame(e, with_labels=with_labels)

    def fid(e):
        return e["scene"], e["token"]

    return files, read, fid


def evaluate_command(cfg: RunConfig, device: Device = "cuda", group: Group = None) -> float:
    from lidal_tpu_torch.data.loader import FrameBatchLoader
    from lidal_tpu_torch.runtime.evaluate import run_eval

    model = _load_eval_variables(cfg, device)
    data = cfg.data
    files, read_fn, _ = _dataset_frames(cfg, "val")
    print("Validation samples:", len(files))
    loader = FrameBatchLoader(
        files,
        lambda p: read_fn(p, with_labels=True),
        point_cap=data.point_cap,
        # reference sk_dataloader.py:44-46 (2x train batch), per rank
        batch_size=2 * data.batch_size * mesh.world(group),
    )
    return run_eval(cfg, model, loader, device, verbose=True, group=group).miou


def prob_inference_command(cfg: RunConfig, device: Device = "cuda", group: Group = None) -> None:
    """Multi-view inference over this rank's contiguous share of the train
    frames (``parallel/mesh.process_shard``: all of them without a process
    group), each frame's views seeded by its index in the whole list."""
    from lidal_tpu_torch.runtime.prob_inference import run_prob_inference

    model = _load_eval_variables(cfg, device)
    files, read_fn, frame_id_fn = _dataset_frames(cfg, "train")
    share = mesh.process_shard(len(files), group)  # reference sk_dataloader.py:196-198
    files = files[share.start : share.stop]
    print("Score samples:", len(files))
    run_prob_inference(
        cfg,
        model,
        files,
        read_fn=lambda p: read_fn(p, with_labels=False),
        frame_id_fn=frame_id_fn,
        verbose=True,
        device=device,
        first_index=share.start,
    )
    mesh.sync_hosts("prob_inference", group)


def fused_score_command(cfg: RunConfig, device: Device = "cuda", group: Group = None) -> None:
    """Fused inference + LiDAL scoring round (``cfg.r_id`` >= 1): one streaming
    pass computes the previous round's multi-view prob maps on the device and
    scores them without the npy round trip (same artifacts, same selections
    as ``prob_inference_command`` + ``score_command``)."""
    from lidal_tpu_torch.active.lidal_runner import _prev_cfg, run_fused_lidal_round

    model = _load_eval_variables(_prev_cfg(cfg), device)
    # enumeration order == run_prob_inference's files order (the frames'
    # generators are seeded from the global index)
    files, read_fn, frame_id_fn = _dataset_frames(cfg, "train")
    frame_index = {frame_id_fn(p): i for i, p in enumerate(files)}
    by_id = {frame_id_fn(p): p for p in files}

    def read_raw(seq: str, name: str):
        xyz, sig, _ = read_fn(by_id[(seq, name)], with_labels=False)
        return xyz, sig

    run_fused_lidal_round(cfg, model, read_raw, frame_index=frame_index, verbose=True, device=device, group=group)


def score_command(cfg: RunConfig, device: Device = "cuda", group: Group = None) -> None:
    m = cfg.metric_name
    if m.startswith("LiDAL"):
        from lidal_tpu_torch.active.lidal_runner import run_lidal_round

        run_lidal_round(cfg, verbose=True, device=device, group=group)
        return
    if mesh.rank(group) != 0:  # rank 0 scores and writes the flags
        mesh.sync_hosts("score", group)
        return
    if m == "ReDAL":
        from lidal_tpu_torch.active.redal_runner import run_redal_round

        run_redal_round(cfg, verbose=True)
    elif cfg.label_unit == "sv" and m == "RAND":
        from lidal_tpu_torch.active.redal_runner import run_sv_rand_round

        run_sv_rand_round(cfg)
    else:
        from lidal_tpu_torch.active.frame_runner import run_frame_metric_round

        run_frame_metric_round(cfg, m, verbose=True, device=device)
    mesh.sync_hosts("score", group)


def prep_command(cfg: RunConfig, stage: str) -> None:
    """Offline preprocessing on the host, SemanticKITTI or nuScenes: ``grids``,
    ``supervoxels`` (native k-means), ``vccs``, ``boundary``, ``bootstrap``."""
    data = cfg.data
    if cfg.dataset_name == "NU":
        from lidal_tpu_torch.data import nuscenes as nu
        from lidal_tpu_torch.runtime.train_loop import nu_seq_frames

        seq_frames = nu_seq_frames(cfg)
        read_xyz = lambda e: nu.read_frame(e, with_labels=False)[0]  # noqa: E731
    else:
        from lidal_tpu_torch.data import semantic_kitti as sk

        seq_frames = {s: sk.list_frames(cfg.data_root, [s]) for s in data.train_split}
        read_xyz = lambda p: sk.read_frame(p, with_labels=False)[0]  # noqa: E731

    if stage == "grids":
        from lidal_tpu_torch.prep.grid import prepare_nu_grids, prepare_sk_grids

        if cfg.dataset_name == "NU":
            prepare_nu_grids(cfg, seq_frames, verbose=True)
        else:
            prepare_sk_grids(cfg, verbose=True)
    elif stage == "supervoxels":
        from lidal_tpu_torch.prep.supervoxel_kmeans import prepare_supervoxels_kmeans

        prepare_supervoxels_kmeans(cfg, seq_frames, read_xyz, verbose=True)
    elif stage == "vccs":
        from lidal_tpu_torch.prep.supervoxel_vccs import prepare_supervoxels_vccs

        prepare_supervoxels_vccs(cfg, seq_frames, read_xyz, verbose=True)
    elif stage == "boundary":
        from lidal_tpu_torch.prep.surface_variation import prepare_surface_variation

        prepare_surface_variation(cfg, seq_frames, read_xyz, verbose=True)
    elif stage == "bootstrap":
        from lidal_tpu_torch.data.selection import bootstrap_round0

        bootstrap_round0(cfg, seq_frames)
    else:
        raise ValueError(f"unknown prep stage: {stage}")


def import_torch_command(cfg: RunConfig, pt_path: str, device: Device = "cuda") -> None:
    """Convert a reference ``current.pt`` (released round-0 anchors, reference
    README.md:88-92) into the round's ``current_port.pt``: its weights, step =
    its iteration, a fresh Adam."""
    from lidal_tpu_torch.runtime import checkpoint as ckpt
    from lidal_tpu_torch.runtime.import_torch import load_torch_checkpoint
    from lidal_tpu_torch.runtime.train_loop import init_state

    state_dict, iteration, ep_id = load_torch_checkpoint(pt_path, spvcnn=cfg.is_spvcnn)
    state = init_state(cfg, torch.device(device))
    state.model.load_state_dict(state_dict, strict=True)
    state.step = iteration
    paths = Paths(cfg)
    ckpt.save_checkpoint(paths.ckpt_dir(), state, ep_id)
    print(f"Imported {pt_path} (iteration {iteration}) -> {ckpt.ckpt_path(paths.ckpt_dir())}")
