"""Fused bf16 conv backward kernel (``csrc/conv_dx_dw_fused.cu``) and its plain
version.

Replaces ``tools/probe_dxdw_features.py:launch`` with its bodies ``kA`` /
``kB`` / ``kC`` as ``mode`` ``"dx"`` / ``"dx_zero_dw"`` / ``"dx_dw"``: reduced
forms of ``ops/cuda_conv_dxdw.conv_dx_dw`` that take both products from ONE
gather per (row tile, tap), on operands rounded to bf16 with f32 sums.  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain version:
the operands cast to bf16 and back to f32, then ``conv_dx_dw_plain``.  The
weight gradient is deterministic (fixed row chunks summed in a fixed order, no
atomics): one input gives bit-equal results on every run.

The kernel takes c_src in multiples of 16 (at most 256) and c_dst, c_f in
multiples of 32; the wrapper zero-pads the channels up to that and slices the
results back (the probe's own shape has 8 channels).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lidal_tpu_torch import kernels_build
from lidal_tpu_torch.ops.cuda_conv_dxdw import _check, conv_dx_dw_plain

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0

MODES = ("dx", "dx_zero_dw", "dx_dw")

_TILE_ROWS = 64  # rows a block stages per step (kBM in the source)
_SLICE = 32  # dx columns and dw rows per block (kSlice)
_C_SRC_ALIGN = 16
_C_SRC_MAX = 256  # the widest dw slice a block's registers hold (kCMax)
_TARGET_BLOCKS = 1024  # blocks wanted: a few waves on 132 SMs
_MIN_CHUNK_ROWS = 1024  # a chunk's rows amortise its partial's write
_MAX_CHUNK_ROWS = 4096  # and a chunk sums few enough rows to stay accurate
_WORKSPACE_BYTES = 256 << 20  # bound on the partials [S, K, c_f, c_src]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad_to(c: int, align: int) -> int:
    return _cdiv(c, align) * align


def conv_dx_dw_fused_plain(src, w2, nbr, f, mode: str = "dx_dw"):
    """Plain torch version of :func:`conv_dx_dw_fused` (same arguments and results)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _check(src, w2, nbr, f)
    dx, dw = conv_dx_dw_plain(src.to(torch.bfloat16).float(), w2.to(torch.bfloat16).float(), nbr,
                              f.to(torch.bfloat16).float())
    if mode == "dx":
        return dx, None
    return dx, (torch.zeros_like(dw) if mode == "dx_zero_dw" else dw)


def row_chunks(m: int, k: int, c_f: int, c_src: int, slices: int):
    """(S, rows per chunk) of the kernel's weight-gradient reduction, for
    padded channel counts and ``slices`` blocks per chunk.

    S depends on the shape only, so a shape always sums in the same order:
    enough chunks for a few waves of blocks, between ``_MIN_CHUNK_ROWS`` and
    ``_MAX_CHUNK_ROWS`` rows each (a multiple of the 64-row tile), and a
    workspace of at most ``_WORKSPACE_BYTES`` (which wins over the row bounds)."""
    if m == 0:
        return 1, _TILE_ROWS
    s = max(min(_cdiv(_TARGET_BLOCKS, slices), m // _MIN_CHUNK_ROWS), _cdiv(m, _MAX_CHUNK_ROWS))
    s = min(s, _WORKSPACE_BYTES // (4 * k * c_f * c_src))
    rows = _pad_to(_cdiv(m, max(1, s)), _TILE_ROWS)
    return _cdiv(m, rows), rows


def conv_dx_dw_fused(src, w2, nbr, f, mode: str = "dx_dw"):
    """Both products of a sparse-conv backward from one gather per (tile, tap).

      dx[i] = sum_k bf16(src)[nbr[i, k]] @ bf16(w2)[k]       f32 [m, c_dst]
      dw[k] = sum_i bf16(f)[i]^T bf16(src)[nbr[i, k]]        f32 [K, c_f, c_src]

    ``mode`` ``"dx"`` returns ``(dx, None)``, ``"dx_zero_dw"`` ``(dx, zeros)``
    and ``"dx_dw"`` ``(dx, dw)``.  An index outside [0, n) contributes zero;
    map columns need not be sorted.

    Args:
      src: f32 [n, c_src], c_src <= 256 (the output gradient of the forward conv).
      w2: f32 [K, c_src, c_dst], K <= 27.
      nbr: int32 [m, K] source rows (sentinel n).
      f: f32 [m, c_f] (the forward input at the map's rows).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if src.device.type == "cpu":
        return conv_dx_dw_fused_plain(src, w2, nbr, f, mode)
    if src.device.type != "cuda":
        raise ValueError(f"conv_dx_dw_fused runs on CPU or CUDA tensors, got {src.device}")
    _check(src, w2, nbr, f)
    dev = src.device
    for name, x, dtype in (("src", src, torch.float32), ("w2", w2, torch.float32),
                           ("nbr", nbr, torch.int32), ("f", f, torch.float32)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}")
    n, c_src = src.shape
    m, k = nbr.shape
    c_dst, c_f = w2.shape[2], f.shape[1]
    cs, cd, cf = _pad_to(c_src, _C_SRC_ALIGN), _pad_to(c_dst, _SLICE), _pad_to(c_f, _SLICE)
    if k > 27 or cs > _C_SRC_MAX:
        raise ValueError(f"conv_dx_dw_fused kernel needs K <= 27 and c_src <= {_C_SRC_MAX}; got {k}, {c_src}")
    with_dw = mode == "dx_dw"
    m_pad = _pad_to(max(m, 1), _TILE_ROWS)
    # the operands as the kernel reads them: bf16, channels zero-padded, w2 with
    # c_src contiguous, the map and f transposed (a block reads a tap's column
    # and a channel's rows contiguously)
    src_b = F.pad(src.to(torch.bfloat16), (0, cs - c_src)).contiguous()
    w2t = F.pad(w2.to(torch.bfloat16), (0, cd - c_dst, 0, cs - c_src)).transpose(1, 2).contiguous()
    nbr_t = nbr.t().contiguous()
    f_t = F.pad(f.to(torch.bfloat16), (0, cf - c_f, 0, m_pad - m)).t().contiguous() if with_dw else None
    slices = max(cd, cf if with_dw else 0) // _SLICE
    chunks, rows = row_chunks(m, k, cf, cs, slices)
    dx = torch.zeros((m, cd), dtype=torch.float32, device=dev)  # the kernel adds into it
    dw = torch.empty((k, cf, cs), dtype=torch.float32, device=dev) if mode != "dx" else None
    ws = torch.empty((chunks, k, cf, cs), dtype=torch.float32, device=dev) if with_dw and chunks > 1 else dw
    fn = kernels_build.function(
        "conv_dx_dw_fused", "lidal_conv_dx_dw_fused", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    )
    with torch.cuda.device(dev):
        err = fn(
            src_b.data_ptr(), w2t.data_ptr(), nbr_t.data_ptr(), f_t.data_ptr() if with_dw else None,
            dx.data_ptr(), dw.data_ptr() if dw is not None else None, ws.data_ptr() if ws is not None else None,
            m, n, k, cs, cd, cf, m_pad, chunks, rows, MODES.index(mode),
            torch.cuda.current_stream().cuda_stream,
        )
    global LAUNCHES
    with kernels_build.LAUNCH_LOCK:
        LAUNCHES += 1
    kernels_build.check(err, "conv_dx_dw_fused")
    if cd != c_dst:
        dx = dx[:, :c_dst].contiguous()
    if dw is not None and (cf != c_f or cs != c_src):
        dw = dw[:, :c_f, :c_src].contiguous()
    return dx, dw
