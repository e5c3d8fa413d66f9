"""Sparse-conv backward kernel (``csrc/conv_dx_dw.cu``) and its plain version.

Replaces ``lidal_tpu/ops/pallas_conv.py:conv_dx_dw_pallas``.  A CUDA tensor
launches the kernel; a CPU tensor takes :func:`conv_dx_dw_plain`, the row-
chunked im2col gather + matmuls that the kernel is tested against.  The
weight-gradient reduction is deterministic: the kernel sums fixed row chunks
in a fixed order, with no atomics, so one input gives bit-equal results on
every run (trained weights feed every selection).
"""

from __future__ import annotations

import ctypes

import torch

from lidal_tpu_torch import kernels_build
from lidal_tpu_torch.ops.cuda_conv import _PLAIN_CHUNK

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0

_ROWS_PER_STEP = 32  # rows a dwg block stages per step (kRows in the source)
_TARGET_BLOCKS = 2048  # dwg blocks wanted: a few waves on 132 SMs
_MIN_CHUNK_ROWS = 1024  # a chunk's rows amortise its partial's write
_MAX_CHUNK_ROWS = 4096  # and a chunk sums few enough rows to stay accurate
_WORKSPACE_BYTES = 256 << 20  # bound on the partials [S, K, c_f, c_src]


def _check(src, w2, nbr, f) -> None:
    if src.dim() != 2 or w2.dim() != 3 or nbr.dim() != 2 or f.dim() != 2:
        raise ValueError(
            f"src [n, c_src], w2 [K, c_src, c_dst], nbr [m, K], f [m, c_f] expected, got "
            f"{tuple(src.shape)}, {tuple(w2.shape)}, {tuple(nbr.shape)}, {tuple(f.shape)}"
        )
    if w2.shape[0] != nbr.shape[1] or w2.shape[1] != src.shape[1] or f.shape[0] != nbr.shape[0]:
        raise ValueError(
            f"w2 {tuple(w2.shape)} and f {tuple(f.shape)} do not fit src {tuple(src.shape)} and nbr {tuple(nbr.shape)}"
        )


def conv_dx_dw_plain(src, w2, nbr, f, need_dx: bool = True):
    """Plain torch version of :func:`conv_dx_dw` (same arguments and results)."""
    _check(src, w2, nbr, f)
    n, c_src = src.shape
    m, k = nbr.shape
    c_dst, c_f = w2.shape[2], f.shape[1]
    sx = torch.cat([src, src.new_zeros((1, c_src))])
    idx = torch.where((nbr >= 0) & (nbr < n), nbr, n).long()
    w2f = w2.reshape(k * c_src, c_dst)
    dx = src.new_empty((m, c_dst)) if need_dx else None
    dwg = src.new_zeros((c_f, k * c_src))
    rows = max(1, _PLAIN_CHUNK // (k * c_src))
    for i0 in range(0, m, rows):
        g = sx[idx[i0 : i0 + rows]].reshape(-1, k * c_src)
        if need_dx:
            dx[i0 : i0 + rows] = g @ w2f
        dwg.addmm_(f[i0 : i0 + rows].T, g)
    return dx, dwg.reshape(c_f, k, c_src).transpose(0, 1).contiguous()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_chunks(m: int, k: int, c_f: int, c_src: int):
    """(S, rows per chunk) of the kernel's weight-gradient reduction.

    S depends on the shape only, so a shape always sums in the same order:
    enough chunks for a few waves of blocks, between ``_MIN_CHUNK_ROWS`` and
    ``_MAX_CHUNK_ROWS`` rows each, and a workspace of at most
    ``_WORKSPACE_BYTES`` (which wins over the row bounds)."""
    if m == 0:
        return 1, 1
    bf = 64 if c_f % 64 == 0 else (32 if c_f % 32 == 0 else 4)
    bs = 64 if c_src % 64 == 0 else 32
    tiles = k * (c_f // bf) * (c_src // bs)
    s = max(min(_cdiv(_TARGET_BLOCKS, tiles), m // _MIN_CHUNK_ROWS), _cdiv(m, _MAX_CHUNK_ROWS))
    s = min(s, _WORKSPACE_BYTES // (4 * k * c_f * c_src))
    rows = _cdiv(_cdiv(m, max(1, s)), _ROWS_PER_STEP) * _ROWS_PER_STEP
    return _cdiv(m, rows), rows


def conv_dx_dw(src, w2, nbr, f, need_dx: bool = True):
    """Both products of a sparse-conv backward over one map.

      dx[i]  = sum_k src[nbr[i, k]] @ w2[k]        f32 [m, c_dst] (None unless need_dx)
      dwg[k] = sum_i f[i]^T src[nbr[i, k]]         f32 [K, c_f, c_src]

    An index outside [0, n) contributes zero; map columns need not be sorted.

    Args:
      src: f32 [n, c_src], c_src % 32 == 0 (the output gradient of the forward conv).
      w2: f32 [K, c_src, c_dst], K <= 27; c_dst % 32 == 0 when ``need_dx``.
      nbr: int32 [m, K] source rows (sentinel n).
      f: f32 [m, c_f], c_f % 4 == 0 (the forward input at the map's rows).
    """
    if src.device.type == "cpu":
        return conv_dx_dw_plain(src, w2, nbr, f, need_dx)
    if src.device.type != "cuda":
        raise ValueError(f"conv_dx_dw runs on CPU or CUDA tensors, got {src.device}")
    _check(src, w2, nbr, f)
    n, c_src = src.shape
    m, k = nbr.shape
    c_dst, c_f = w2.shape[2], f.shape[1]
    if k > 27 or c_src % 32 or c_f % 4 or (need_dx and c_dst % 32):
        raise ValueError(
            f"conv_dx_dw kernel needs K <= 27, c_src % 32 == 0, c_f % 4 == 0 and, for dx, "
            f"c_dst % 32 == 0; got {k}, {c_src}, {c_f}, {c_dst}"
        )
    for name, x, dtype in (("src", src, torch.float32), ("w2", w2, torch.float32),
                           ("nbr", nbr, torch.int32), ("f", f, torch.float32)):
        if x.device != src.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {src.device}")
    if src.data_ptr() % 16 or w2.data_ptr() % 16 or f.data_ptr() % 16:
        raise ValueError("src, w2 and f must be 16-byte aligned (float4 loads)")
    chunks, rows = row_chunks(m, k, c_f, c_src)
    dev = src.device
    dx = torch.empty((m, c_dst), dtype=torch.float32, device=dev) if need_dx else None
    dwg = torch.empty((k, c_f, c_src), dtype=torch.float32, device=dev)
    ws = torch.empty((chunks, k, c_f, c_src), dtype=torch.float32, device=dev) if chunks > 1 else dwg
    nbr_t = nbr.t().contiguous()
    lib = kernels_build.load("conv_dx_dw")
    fn = lib.lidal_conv_dx_dw
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(
            src.data_ptr(), w2.data_ptr(), nbr.data_ptr(), nbr_t.data_ptr(), f.data_ptr(),
            dx.data_ptr() if need_dx else None, dwg.data_ptr(), ws.data_ptr(),
            m, n, k, c_src, c_dst, c_f, chunks, rows, int(need_dx),
            torch.cuda.current_stream().cuda_stream,
        )
    global LAUNCHES
    LAUNCHES += 1
    kernels_build.check(err, "conv_dx_dw")
    return dx, dwg
