"""Fused bf16 conv backward kernel (``csrc/conv_dx_dw_fused.cu``) and its plain
version.

On the bf16 route (``ops/conv.py``, ``BF16_OPERANDS``) it is the backward of
every conv of a train step, in place of
``lidal_tpu/ops/pallas_conv.py:conv_dx_dw_pallas`` (mode ``"dx_dw"``, with
``need_dx=False`` where the conv's input needs no gradient: the stem).  It
also replaces ``tools/probe_dxdw_features.py:launch`` with its bodies ``kA`` /
``kB`` / ``kC`` as ``mode`` ``"dx"`` / ``"dx_zero_dw"`` / ``"dx_dw"``: reduced
forms of ``ops/cuda_conv_dxdw.conv_dx_dw`` on operands rounded to bf16 with
f32 sums.  A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version: the operands cast to bf16 and back to f32, then
``conv_dx_dw_plain``.

One call is one launch of the C entry point, which runs dx on the bf16
gather-GEMM tile of ``csrc/gather_gemm_bf16.cuh`` (the kernel of
``cuda_conv_bf16``, with its tile and ring as ``conv_gather_first`` picks
them) and, in mode ``"dx_dw"``, dw over per-tap lists of the real pairs built
on the device, one ``mma.sync.m16n8k16`` per product, in chunks of
``pair_chunks(..., stage=128)`` pairs whose partials are summed in chunk order
with no atomics: one input gives bit-equal results on every run, and the host
never waits on the lists.  What bounds it on an H100: dx as the tile (on the
sparse maps of a train step, the products of active taps on rows without a
real pair); dw the L2 bandwidth for the gathered f and src rows of each pair.

The kernel takes c_src, c_dst and c_f in multiples of 32; the wrapper
zero-pads the channels up to that and slices the results back (the probe's
own shape has 8 channels).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lidal_tpu_torch import kernels_build
from lidal_tpu_torch.ops.cuda_conv_bf16 import bf16_padded, column_tile, ring_stages, tile_rows
from lidal_tpu_torch.ops.cuda_conv_dxdw import _SEG_ROWS, _check, conv_dx_dw_plain, pair_chunks
from lidal_tpu_torch.utils import profiling

MODES = ("dx", "dx_zero_dw", "dx_dw")
DW_ONLY = 3  # the C entry's mode for "dx_dw" with need_dx=False

CHANNEL_ALIGN = 32  # c_src, c_dst and c_f as the kernel takes them
PAIRS_PER_STAGE = 128  # pairs a dw block stages at a time (kStage in the source)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad_to(c: int, align: int) -> int:
    return _cdiv(c, align) * align


def padded_channels(c_src: int, c_dst: int, c_f: int):
    """(c_src, c_dst, c_f) as the kernel takes them: each zero-padded to a multiple of 32."""
    return tuple(_pad_to(c, CHANNEL_ALIGN) for c in (c_src, c_dst, c_f))


def dw_chunks(m: int, k: int, c_f: int, c_src: int):
    """(S, pairs per chunk P) of the kernel's weight-gradient reduction at the
    padded widths: ``cuda_conv_dxdw.pair_chunks`` with the bf16 kernel's
    128-pair stage."""
    return pair_chunks(m, k, c_f, c_src, stage=PAIRS_PER_STAGE)


def _check_mode(mode: str, need_dx: bool) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not need_dx and mode != "dx_dw":
        raise ValueError(f"need_dx=False goes with mode 'dx_dw' (dw alone), got {mode!r}")


def conv_dx_dw_fused_plain(src, w2, nbr, f, mode: str = "dx_dw", need_dx: bool = True):
    """Plain torch version of :func:`conv_dx_dw_fused` (same arguments and results)."""
    _check_mode(mode, need_dx)
    _check(src, w2, nbr, f)
    dx, dw = conv_dx_dw_plain(src.to(torch.bfloat16).float(), w2.to(torch.bfloat16).float(), nbr,
                              f.to(torch.bfloat16).float(), need_dx)
    if mode == "dx":
        return dx, None
    return dx, (torch.zeros_like(dw) if mode == "dx_zero_dw" else dw)


def conv_dx_dw_fused(src, w2, nbr, f, mode: str = "dx_dw", need_dx: bool = True):
    """Both products of a sparse-conv backward on bf16 operands.

      dx[i] = sum_k bf16(src)[nbr[i, k]] @ bf16(w2)[k]       f32 [m, c_dst]
      dw[k] = sum_i bf16(f)[i]^T bf16(src)[nbr[i, k]]        f32 [K, c_f, c_src]

    ``mode`` ``"dx"`` returns ``(dx, None)``, ``"dx_zero_dw"`` ``(dx, zeros)``
    and ``"dx_dw"`` ``(dx, dw)``, or with ``need_dx=False`` ``(None, dw)``: dw
    alone, dx's tile not launched.  An index outside [0, n) contributes zero;
    map columns need not be sorted.  dx is the bf16 gather-GEMM tile (sums over
    a row's taps in registers, each output written once); dw runs over each
    tap's real pairs, one ``mma.sync.m16n8k16`` per product.

    Args:
      src: f32 [n, c_src] (the output gradient of the forward conv).
      w2: f32 [K, c_src, c_dst], K <= 27.
      nbr: int32 [m, K] source rows (sentinel n).
      f: f32 [m, c_f] (the forward input at the map's rows).
    """
    _check_mode(mode, need_dx)
    if src.device.type == "cpu":
        return conv_dx_dw_fused_plain(src, w2, nbr, f, mode, need_dx)
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
    if k > 27:
        raise ValueError(f"conv_dx_dw_fused kernel needs K <= 27; got {k}")
    cs, cd, cf = padded_channels(c_src, c_dst, c_f)
    with_dw = mode == "dx_dw"
    # the operands as the kernel reads them: bf16, channels zero-padded, w2 with
    # c_src contiguous
    src_b = bf16_padded(src, cs)
    if cd != c_dst or cs != c_src:
        w2 = F.pad(w2, (0, cd - c_dst, 0, cs - c_src))
    w2t = w2.transpose(1, 2).to(torch.bfloat16, memory_format=torch.contiguous_format)
    chunks, per_chunk = dw_chunks(m, k, cf, cs)
    dx = torch.empty((m, cd), dtype=torch.float32, device=dev) if need_dx else None
    dw = torch.empty((k, cf, cs), dtype=torch.float32, device=dev) if mode != "dx" else None
    # mode "dx_dw" only: f in bf16, the partials, and one int32 buffer for the map
    # transposed [k, m] (by the launch), the lists [k, m], counts [k] and seg_counts
    f_b = ws = ints = None
    nbr_t = rows = counts = seg_counts = None
    if with_dw:
        f_b = bf16_padded(f, cf)
        ws = torch.empty((k, chunks, cf, cs), dtype=torch.float32, device=dev) if chunks > 1 else None
        ints = torch.empty(2 * k * m + k + k * max(1, _cdiv(m, _SEG_ROWS)), dtype=torch.int32, device=dev)
        nbr_t = ints.data_ptr()
        rows, counts = nbr_t + 4 * k * m, nbr_t + 8 * k * m
        seg_counts = counts + 4 * k
    bn = column_tile(cd)
    bm = tile_rows(bn, m, cd)
    fn = kernels_build.function(
        "conv_dx_dw_fused", "lidal_conv_dx_dw_fused", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    )
    with torch.cuda.device(dev):
        err = fn(
            src_b.data_ptr(), w2t.data_ptr(), nbr.data_ptr(), nbr_t, f_b.data_ptr() if with_dw else None,
            dx.data_ptr() if need_dx else None, dw.data_ptr() if dw is not None else None,
            ws.data_ptr() if ws is not None else None, rows, counts, seg_counts,
            m, n, k, cs, cd, cf, bn, bm, ring_stages(bn, bm, False), chunks, per_chunk,
            MODES.index(mode) if need_dx else DW_ONLY,
            torch.cuda.current_stream().cuda_stream,
        )
    profiling.count("launch.conv_dx_dw_fused")
    kernels_build.check(err, "conv_dx_dw_fused")
    if need_dx and cd != c_dst:
        dx = dx[:, :c_dst].contiguous()
    if dw is not None and (cf != c_f or cs != c_src):
        dw = dw[:, :c_f, :c_src].contiguous()
    return dx, dw
