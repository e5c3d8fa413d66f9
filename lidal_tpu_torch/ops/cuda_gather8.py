"""Weighted 8-tap gather and its transpose (``csrc/gather8.cu``) with their
plain versions: the point<->voxel transfers of SPVCNN.

Replaces ``lidal_tpu/ops/pallas_gather8.py``: ``gather8_pallas``,
``scatter8_pallas`` and the ``custom_vjp`` ``gather8`` around them.

    gather8:   out[i]    = sum_{k < 8} w8[i, k] * feats[nbr[i, k]]
    scatter8:  dfeats[t] = sum_{(i, k): nbr[i, k] == t} w8[i, k] * dy[i]

An index outside ``[0, n)`` is the sentinel and contributes zero; map columns
need not be sorted.  A CUDA tensor launches the kernel; a CPU tensor takes the
plain version.  ``gather8`` is bit-equal to :func:`gather8_plain` (the same
products and sums in the same order, each rounded on its own).  ``scatter8``
sums without atomics in an order the map fixes, so it gives the same bits on
every run; :func:`scatter8_plain` is ``index_add_``, whose order on a card is
not fixed, so the two agree within a tolerance scaled by ``sum |w8| |dy|`` per
target.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lidal_tpu_torch import kernels_build

TAPS = 8

# Kernel launches since import (or since a caller reset them).
GATHER8_LAUNCHES = 0
SCATTER8_LAUNCHES = 0

_MAX_SCATTER_C = 1024  # one block of 256 threads covers a row in 16-byte slices


def _check(rows, nbr, w8) -> None:
    if rows.dim() != 2 or nbr.dim() != 2 or nbr.shape[1] != TAPS or w8.shape != nbr.shape:
        raise ValueError(
            f"rows [., c], nbr [m, {TAPS}] and w8 [m, {TAPS}] expected, got "
            f"{tuple(rows.shape)}, {tuple(nbr.shape)}, {tuple(w8.shape)}"
        )


def _check_cuda(what: str, rows, nbr, w8) -> None:
    for name, x, dtype in ((what, rows, torch.float32), ("nbr", nbr, torch.int32), ("w8", w8, torch.float32)):
        if x.device != rows.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {rows.device}")
    if rows.shape[1] % 4 or rows.data_ptr() % 16:
        raise ValueError(f"the kernel needs c % 4 == 0 and 16-byte aligned rows (float4 loads); c = {rows.shape[1]}")
    if nbr.numel() >= 2**31:
        raise ValueError(f"the map has {nbr.numel()} (row, tap) pairs, the kernel indexes them in 32 bits")


def _safe_index(nbr: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where((nbr >= 0) & (nbr < n), nbr, n).long()


def gather8_plain(feats: torch.Tensor, nbr: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`gather8_forward`: an explicit loop over
    the taps in ascending k, a product and a sum per tap (no ``einsum``, whose
    order is the library's), so the kernel can match it bit for bit."""
    _check(feats, nbr, w8)
    n = feats.shape[0]
    fx = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
    idx = _safe_index(nbr, n)
    w = w8.to(feats.dtype)
    out = feats.new_zeros((nbr.shape[0], feats.shape[1]))
    for k in range(TAPS):
        out += w[:, k, None] * fx[idx[:, k]]
    return out


def gather8_forward(feats: torch.Tensor, nbr: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k w8[i, k] * feats[nbr[i, k]], f32 [m, c]; no gradient.

    Args:
      feats: f32 [n, c], c % 4 == 0 on a card.
      nbr: int32 [m, 8] source rows (sentinel n), columns in any order.
      w8: f32 [m, 8] weights.
    """
    if feats.device.type == "cpu":
        return gather8_plain(feats, nbr, w8)
    if feats.device.type != "cuda":
        raise ValueError(f"gather8 runs on CPU or CUDA tensors, got {feats.device}")
    _check(feats, nbr, w8)
    _check_cuda("feats", feats, nbr, w8)
    n, c = feats.shape
    m = nbr.shape[0]
    out = torch.empty((m, c), dtype=torch.float32, device=feats.device)
    if m * c == 0:
        return out
    lib = kernels_build.load("gather8")
    fn = lib.lidal_gather8
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(feats.device):
        err = fn(feats.data_ptr(), nbr.data_ptr(), w8.data_ptr(), out.data_ptr(), m, n, c,
                 torch.cuda.current_stream().cuda_stream)
    global GATHER8_LAUNCHES
    with kernels_build.LAUNCH_LOCK:
        GATHER8_LAUNCHES += 1
    kernels_build.check(err, "gather8")
    return out


def scatter8_plain(dy: torch.Tensor, nbr: torch.Tensor, w8: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch version of :func:`scatter8`: the ``[m, 8, c]`` weighted
    cotangent added into its targets by ``index_add_``, sentinels dropped (the
    form the JAX package uses off the TPU)."""
    _check(dy, nbr, w8)
    c = dy.shape[1]
    contrib = (w8.to(dy.dtype)[:, :, None] * dy[:, None, :]).reshape(-1, c)
    out = dy.new_zeros((n + 1, c))
    out.index_add_(0, _safe_index(nbr, n).reshape(-1), contrib)
    return out[:n]


def build_transpose(nbr: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The map seen from its targets, as plan data for the scatter8 kernel:
    ``order`` int32 [m * 8], the (row, tap) pairs ``i * 8 + k`` sorted by
    target (stable, so a target's pairs ascend; sentinels last), and
    ``offsets`` int32 [n + 1]: target t owns ``order[offsets[t]:offsets[t + 1]]``.
    Integer sorting and searching only, so the result is the same on every run."""
    key = torch.where((nbr >= 0) & (nbr < n), nbr, n).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    targets = torch.arange(n + 1, dtype=key.dtype, device=key.device)
    offsets = torch.searchsorted(sorted_key, targets, out_int32=True)
    return order.to(torch.int32), offsets


def scatter8(dy: torch.Tensor, nbr: torch.Tensor, w8: torch.Tensor, n: int) -> torch.Tensor:
    """dfeats[t] = sum over the pairs with nbr[i, k] == t of w8[i, k] * dy[i],
    f32 [n, c]: the gradient of :func:`gather8` with respect to ``feats``.

    Args:
      dy: f32 [m, c], c % 4 == 0 and c <= 1024 on a card.
      nbr: int32 [m, 8] target rows (sentinel n), columns in any order.
      w8: f32 [m, 8] weights.
      n: rows of the result.
    """
    if dy.device.type == "cpu":
        return scatter8_plain(dy, nbr, w8, n)
    if dy.device.type != "cuda":
        raise ValueError(f"scatter8 runs on CPU or CUDA tensors, got {dy.device}")
    _check(dy, nbr, w8)
    _check_cuda("dy", dy, nbr, w8)
    c = dy.shape[1]
    if c > _MAX_SCATTER_C:
        raise ValueError(f"scatter8 kernel takes c <= {_MAX_SCATTER_C}, got {c}")
    if n >= 2**31 - 1:
        raise ValueError(f"scatter8: n = {n} too large")
    out = torch.empty((n, c), dtype=torch.float32, device=dy.device)
    if n * c == 0:
        return out
    order, offsets = build_transpose(nbr, n)
    lib = kernels_build.load("gather8")
    fn = lib.lidal_scatter8
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dy.device):
        err = fn(dy.data_ptr(), w8.data_ptr(), order.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, c,
                 torch.cuda.current_stream().cuda_stream)
    global SCATTER8_LAUNCHES
    with kernels_build.LAUNCH_LOCK:
        SCATTER8_LAUNCHES += 1
    kernels_build.check(err, "scatter8")
    return out


class _Gather8(torch.autograd.Function):
    """``gather8_forward`` with ``scatter8`` as its backward.  The map and its
    weights are plan data, never parameters: both get no gradient (the JAX
    package's ``custom_vjp`` returns a zero weight cotangent by contract)."""

    @staticmethod
    def forward(ctx, feats, nbr, w8):
        ctx.save_for_backward(nbr, w8)
        ctx.n = feats.shape[0]
        return gather8_forward(feats.contiguous(), nbr, w8)

    @staticmethod
    def backward(ctx, dy):
        nbr, w8 = ctx.saved_tensors
        return scatter8(dy.contiguous(), nbr, w8, ctx.n), None, None


def gather8(feats: torch.Tensor, nbr: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`gather8_forward`: d/dfeats is :func:`scatter8`;
    ``nbr`` and ``w8`` get ``None``."""
    return _Gather8.apply(feats, nbr, w8)
