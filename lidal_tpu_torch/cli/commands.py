"""Command implementations wiring the run loops, data and checkpoints (port of
``lidal_tpu/cli/commands.py``: SemanticKITTI, MinkUNet or SPVCNN, LiDAL).

Every command runs on ``device`` (default: the CUDA card) and builds the model
family ``cfg.model_name`` names (``runtime/train_loop.build_model``).  The nuScenes
branch of ``_dataset_frames``, ``prep_command``, ``import_torch_command`` and
the scoring metrics other than LiDAL are not ported yet.
"""

from __future__ import annotations

from typing import Union

import torch

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.runtime.paths import Paths

Device = Union[torch.device, str]


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
    if cfg.dataset_name != "SK":
        raise NotImplementedError("the port reads SemanticKITTI; nuScenes is not ported yet (ROADMAP item 18)")
    from lidal_tpu_torch.data import semantic_kitti as sk

    data = cfg.data
    seqs = data.train_split if split == "train" else data.val_split
    return sk.list_frames(cfg.data_root, seqs), sk.read_frame, sk.frame_id


def evaluate_command(cfg: RunConfig, device: Device = "cuda") -> float:
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
        batch_size=2 * data.batch_size,  # reference sk_dataloader.py:44-46 (2x train batch)
    )
    return run_eval(cfg, model, loader, device, verbose=True).miou


def prob_inference_command(cfg: RunConfig, device: Device = "cuda") -> None:
    from lidal_tpu_torch.runtime.prob_inference import run_prob_inference

    model = _load_eval_variables(cfg, device)
    files, read_fn, frame_id_fn = _dataset_frames(cfg, "train")
    print("Score samples:", len(files))
    run_prob_inference(
        cfg,
        model,
        files,
        read_fn=lambda p: read_fn(p, with_labels=False),
        frame_id_fn=frame_id_fn,
        verbose=True,
        device=device,
    )


def fused_score_command(cfg: RunConfig, device: Device = "cuda") -> None:
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

    run_fused_lidal_round(cfg, model, read_raw, frame_index=frame_index, verbose=True, device=device)


def score_command(cfg: RunConfig, device: Device = "cuda") -> None:
    if not cfg.metric_name.startswith("LiDAL"):
        raise NotImplementedError(
            f"scoring metric {cfg.metric_name!r} is not ported yet: the port scores LiDAL (ROADMAP item 17)"
        )
    from lidal_tpu_torch.active.lidal_runner import run_lidal_round

    run_lidal_round(cfg, verbose=True, device=device)
