"""Checkpointing with round warm-start semantics (port of
``lidal_tpu/runtime/checkpoint.py``).

Reference behavior (``train.py:59-87,148-155``): save {model_state, iteration,
ep_id} every 500 iters; on start, resume the same round's checkpoint if
present, else warm-start the weights (not the optimizer or the step) from the
previous round (round 1 from ``0r``).  Here one ``torch.save`` file holds
``{model_state, optimizer, iteration, ep_id}``.

The file is ``<dir>/current_port.pt``, not the reference's ``current.pt``:
its conv kernels are in the JAX layout ``[K, cin, cout]`` with x-major taps
(``models/layers.py``), and the JAX package's ``import-torch`` command reads a
``current.pt`` as a torchsparse checkpoint, so it would misread this one.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from lidal_tpu_torch.runtime.paths import Paths, ensure_dir
from lidal_tpu_torch.runtime.train import TrainState

CKPT_NAME = "current_port.pt"


def ckpt_path(directory: str) -> str:
    return os.path.abspath(os.path.join(directory, CKPT_NAME))


def save_checkpoint(directory: str, state: TrainState, ep_id: int) -> None:
    ensure_dir(directory)
    path = ckpt_path(directory)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(
        {
            "model_state": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "iteration": state.step,
            "ep_id": ep_id,
        },
        tmp,
    )
    os.replace(tmp, path)  # a reader never sees a partial file


def _load(directory: str, state: TrainState) -> Optional[dict]:
    path = ckpt_path(directory)
    if not os.path.exists(path):
        return None
    device = next(state.model.parameters()).device
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(directory: str, state: TrainState) -> Optional[int]:
    """Full resume into ``state`` (weights, BN statistics, optimizer, step).
    Returns the saved ep_id, or None when there is no checkpoint."""
    tree = _load(directory, state)
    if tree is None:
        return None
    state.model.load_state_dict(tree["model_state"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["iteration"])
    return int(tree["ep_id"])


def restore_weights(directory: str, state: TrainState) -> bool:
    """Warm start: weights + BN statistics only; the optimizer and the step
    stay fresh (train.py:73-85).  Returns whether a checkpoint was found."""
    tree = _load(directory, state)
    if tree is None:
        return False
    state.model.load_state_dict(tree["model_state"])
    return True


def resume_or_warm_start(paths: Paths, state: TrainState) -> Tuple[TrainState, int]:
    """The reference's resume policy: same-round checkpoint -> previous round -> fresh."""
    ep_id = restore_checkpoint(paths.ckpt_dir(), state)
    if ep_id is not None:
        return state, ep_id
    if paths.cfg.r_id > 0:
        restore_weights(paths.warm_start_ckpt_dir(), state)
    return state, 0
