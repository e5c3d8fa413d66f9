"""Import the reference's released torch checkpoints into the port's MinkUNet /
SPVCNN (port of ``lidal_tpu/runtime/import_torch.py``).

The reference publishes four round-0 ``current.pt`` files "for benchmarking
purposes" (reference ``README.md:88-92``: SK/NU x SPVCNN/MinkUNet); loading
them is the accuracy-parity anchor.  A ``current.pt`` holds
``{model_state_dict, iteration, ep_id}`` (reference ``train.py:151-155``) with
torchsparse-1.4 module names (``network/minkunet.py:22-89``,
``network/spvcnn.py:21-104``, ``network/utils.py:105-172``).

The port's modules already carry those names, and BatchNorm and Linear keep
torch's layouts, so the conversion touches the conv kernels alone:

* spnn.Conv3d kernels are ``[K, cin, cout]`` like the port's, but
  torchsparse-1.4 enumerates kernel offsets ASYMMETRICALLY (see
  ``TS14_OFFSETS_ODD3`` / ``TS14_OFFSETS_EVEN2`` below): odd kernels
  x-fastest/z-slowest, EVEN kernels z-fastest/x-slowest.  The port's
  rulebooks are x-major (z fastest) for both (``ops/kernel_map.py``), so
  kernel-3 taps are permuted and kernel-2 taps map 1:1.  ks=1 kernels may be
  stored as [cin, cout].
* ``num_batches_tracked`` of torch's BatchNorm has no counterpart (the port's
  ``MaskedBatchNorm`` uses a fixed momentum) and is dropped.

DDP checkpoints prefix every name with ``module.`` — stripped transparently.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------------------
# torchsparse-1.4 kernel-offset enumeration, hard-coded as the external anchor.
# Provenance: torchsparse 1.4.0 ``torchsparse/nn/utils/kernel.py::get_kernel_offsets``
# — the enumeration the reference imports at ``network/utils.py:6,69`` — builds,
# for size k per axis ``np.arange(-k // 2 + 1, k // 2 + 1) * stride``:
#
#   odd  kernel volume: ``[[x, y, z] for z in Z for y in Y for x in X]``
#   even kernel volume: ``[[x, y, z] for x in X for y in Y for z in Z]``
#
# The tables below are that enumeration written out literally so the
# permutation tests anchor against data, not against a re-implementation of
# the same loop.
# --------------------------------------------------------------------------------------

# fmt: off
TS14_OFFSETS_ODD3: Tuple[Tuple[int, int, int], ...] = (
    (-1, -1, -1), (0, -1, -1), (1, -1, -1),
    (-1,  0, -1), (0,  0, -1), (1,  0, -1),
    (-1,  1, -1), (0,  1, -1), (1,  1, -1),
    (-1, -1,  0), (0, -1,  0), (1, -1,  0),
    (-1,  0,  0), (0,  0,  0), (1,  0,  0),
    (-1,  1,  0), (0,  1,  0), (1,  1,  0),
    (-1, -1,  1), (0, -1,  1), (1, -1,  1),
    (-1,  0,  1), (0,  0,  1), (1,  0,  1),
    (-1,  1,  1), (0,  1,  1), (1,  1,  1),
)
TS14_OFFSETS_EVEN2: Tuple[Tuple[int, int, int], ...] = (
    (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
    (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1),
)
# fmt: on


def _perm3() -> list:
    """ours[k] = theirs[perm[k]] for the 27 kernel-3 taps: ours enumerates
    x-major/z-fastest, torchsparse-1.4 odd kernels x-fastest/z-major."""
    perm = []
    for ix in range(3):
        for iy in range(3):
            for iz in range(3):
                perm.append(ix + 3 * iy + 9 * iz)
    return perm


def _tensor(v) -> torch.Tensor:
    """A float32 CPU copy of a tensor or array."""
    t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
    return t.to(torch.float32).clone()


def _conv_w(w: torch.Tensor) -> torch.Tensor:
    """A torchsparse-1.4 kernel in the port's layout.  Kernel-2 taps map 1:1:
    torchsparse enumerates EVEN kernels x-major/z-fastest, the port's
    ``ops/kernel_map.OFFSETS2`` order (TS14_OFFSETS_EVEN2)."""
    if w.ndim == 2:  # a ks=1 kernel stored as [cin, cout]
        return w[None]
    if w.shape[0] == 27:
        return w[_perm3()]
    assert w.shape[0] in (1, 8), w.shape
    return w


def _strip_ddp(sd: dict) -> dict:
    return {k[len("module.") :] if k.startswith("module.") else k: v for k, v in sd.items()}


def _convert(sd: dict, point_branch: bool) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, v in _strip_ddp(sd).items():
        if name.endswith(".num_batches_tracked") or (name.startswith("point_transforms.") and not point_branch):
            continue
        w = _tensor(v)
        out[name] = _conv_w(w) if name.endswith(".kernel") else w
    if point_branch and "point_transforms.0.0.weight" not in out:
        raise ValueError("the state dict holds no point transforms: not an SPVCNN checkpoint")
    return out


def convert_minkunet_state_dict(sd: dict) -> Dict[str, torch.Tensor]:
    """torch ``model_state_dict`` (tensors or numpy arrays, torchsparse-1.4
    layout) -> a state dict for the port's ``models.minkunet.MinkUNet``."""
    return _convert(sd, point_branch=False)


def convert_spvcnn_state_dict(sd: dict) -> Dict[str, torch.Tensor]:
    """torch ``model_state_dict`` -> a state dict for ``models.spvcnn.SPVCNN``:
    the shared trunk plus the three point-transform MLPs
    (``network/spvcnn.py:87-104``: Linear -> BatchNorm1d -> ReLU)."""
    return _convert(sd, point_branch=True)


def _export(sd: dict) -> Dict[str, torch.Tensor]:
    inv3 = np.argsort(_perm3()).tolist()
    out: Dict[str, torch.Tensor] = {}
    for name, v in sd.items():
        w = _tensor(v)
        if name.endswith(".kernel") and w.shape[0] in (1, 27):
            w = w[0] if w.shape[0] == 1 else w[inv3]
        out[name] = w
    return out


def export_minkunet_state_dict(sd: dict) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_minkunet_state_dict`: the port's state dict in
    the torchsparse-1.4 layout (ks=1 kernels as [cin, cout])."""
    return _export({k: v for k, v in sd.items() if not k.startswith("point_transforms.")})


def export_spvcnn_state_dict(sd: dict) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_spvcnn_state_dict`."""
    if "point_transforms.0.0.weight" not in sd:
        raise ValueError("the state dict holds no point transforms: not an SPVCNN model")
    return _export(sd)


def load_torch_checkpoint(path: str, spvcnn: bool = False) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Read a reference ``current.pt`` -> (the port's state dict, iteration, ep_id).

    ``spvcnn`` selects the SPVCNN names (auto-detected from the state dict
    when the point-transform keys are present)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob["model_state_dict"]
    if spvcnn or any("point_transforms" in k for k in sd):
        state_dict = convert_spvcnn_state_dict(sd)
    else:
        state_dict = convert_minkunet_state_dict(sd)
    return state_dict, int(blob.get("iteration", 0)), int(blob.get("ep_id", 0))
