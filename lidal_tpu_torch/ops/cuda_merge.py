"""Sorted-key lookup kernel (``csrc/merge_lookup.cu``) and its plain version.

Replaces ``lidal_tpu/ops/pallas_merge.py:merge_rank_pallas``.  A CUDA tensor
launches the kernel; a CPU tensor takes :func:`lookup_sorted_plain`, the
``torch.searchsorted`` formulation the kernel is tested against.  The kernel
searches each tile of a stream's queries inside the table rows between the
tile's min and max key; :func:`wide_tiles` counts the tiles whose window is too
wide for its shared-memory stage.
"""

from __future__ import annotations

import ctypes

import torch

from lidal_tpu_torch import kernels_build
from lidal_tpu_torch.ops.hashing import SENTINEL_KEY, key64
from lidal_tpu_torch.utils import profiling


def _check(t_hi, t_lo, q_hi, q_lo) -> tuple:
    if t_hi.dim() != 2 or q_hi.dim() != 2:
        raise ValueError(f"tables [T, n] and queries [S, m] expected, got {tuple(t_hi.shape)}, {tuple(q_hi.shape)}")
    if t_lo.shape != t_hi.shape or q_lo.shape != q_hi.shape:
        raise ValueError("hi and lo keys must have the same shape")
    t, n = t_hi.shape
    s, m = q_hi.shape
    if t == 0 or s % t != 0:
        raise ValueError(f"{s} query streams cannot share {t} tables evenly")
    return t, n, s, m


def _check_cuda(t_hi, t_lo, q_hi, q_lo) -> tuple:
    t, n, s, m = _check(t_hi, t_lo, q_hi, q_lo)
    for name, x in (("t_hi", t_hi), ("t_lo", t_lo), ("q_hi", q_hi), ("q_lo", q_lo)):
        if x.device != q_hi.device or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {q_hi.device}")
    return t, n, s, m


def lookup_sorted_plain(t_hi, t_lo, q_hi, q_lo, with_found: bool) -> torch.Tensor:
    """Plain torch version of :func:`lookup_sorted` (same arguments)."""
    t, n, s, m = _check(t_hi, t_lo, q_hi, q_lo)
    if n == 0:
        return torch.zeros((s, m), dtype=torch.int32, device=q_hi.device)
    tk = key64(t_hi, t_lo)  # [T, n]
    qk = key64(q_hi, q_lo).reshape(t, (s // t) * m)  # streams of one table side by side
    lb = torch.searchsorted(tk, qk)
    if with_found:
        hit = (tk.gather(1, lb.clamp(max=n - 1)) == qk) & (lb < n)
        hit &= q_hi.reshape(t, -1) != SENTINEL_KEY
        lb = torch.where(hit, lb, n)
    return lb.reshape(s, m).to(torch.int32)


def lookup_sorted(t_hi, t_lo, q_hi, q_lo, with_found: bool) -> torch.Tensor:
    """Per-query lower bound (or, ``with_found``, matching row else ``n``).

    Args:
      t_hi/t_lo: int32 [T, n] sorted (hi, lo) key tables, sentinel tails.
      q_hi/q_lo: int32 [S, m] sorted query streams, S a multiple of T; the
        S // T consecutive streams from ``s * (S // T)`` search table ``s``.
      with_found: return the table row holding the query, or ``n`` on a miss
        or a sentinel query, instead of the lower bound.

    Returns: int32 [S, m].
    """
    if q_hi.device.type == "cpu":
        return lookup_sorted_plain(t_hi, t_lo, q_hi, q_lo, with_found)
    if q_hi.device.type != "cuda":
        raise ValueError(f"lookup_sorted runs on CPU or CUDA tensors, got {q_hi.device}")
    t, n, s, m = _check_cuda(t_hi, t_lo, q_hi, q_lo)
    out = torch.empty((s, m), dtype=torch.int32, device=q_hi.device)
    if s * m == 0:
        return out
    fn = kernels_build.function(
        "merge_lookup", "lidal_lookup_sorted", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    with torch.cuda.device(q_hi.device):
        err = fn(
            t_hi.data_ptr(), t_lo.data_ptr(), q_hi.data_ptr(), q_lo.data_ptr(), out.data_ptr(),
            t, s // t, n, m, int(with_found), torch.cuda.current_stream().cuda_stream,
        )
    profiling.count("launch.lookup_sorted")
    kernels_build.check(err, "lookup_sorted")
    return out


def wide_tiles(t_hi, t_lo, q_hi, q_lo) -> tuple:
    """(tiles whose window is searched in device memory, all tiles) of the
    kernel's launch on these CUDA tensors (same arguments as
    :func:`lookup_sorted`); the window code is the kernel's own."""
    if q_hi.device.type != "cuda":
        raise ValueError(f"wide_tiles counts the CUDA kernel's tiles, got {q_hi.device}")
    t, n, s, m = _check_cuda(t_hi, t_lo, q_hi, q_lo)
    count = torch.zeros(2, dtype=torch.int32, device=q_hi.device)
    if s * m:
        fn = kernels_build.function(
            "merge_lookup", "lidal_lookup_wide_tiles", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        with torch.cuda.device(q_hi.device):
            err = fn(
                t_hi.data_ptr(), t_lo.data_ptr(), q_hi.data_ptr(), q_lo.data_ptr(), count.data_ptr(),
                t, s // t, n, m, torch.cuda.current_stream().cuda_stream,
            )
        kernels_build.check(err, "lookup wide_tiles")
    return int(count[0]), int(count[1])
