"""Sparse-conv backward kernel (``csrc/conv_dx_dw.cu``) and its plain version.

Replaces ``lidal_tpu/ops/pallas_conv.py:conv_dx_dw_pallas``.  A CUDA tensor
launches the kernel; a CPU tensor takes :func:`conv_dx_dw_plain`, the row-
chunked im2col gather + matmuls that the kernel is tested against.  The
kernel's weight gradient runs over per-tap lists of the real (row, tap) pairs
(built on the device; :func:`pair_lists_plain` is their plain version) in
chunks of a fixed number of pairs (:func:`pair_chunks`), whose partials it
sums in chunk order with no atomics, so one input gives bit-equal results on
every run (trained weights feed every selection), and the host never waits
for the lists.
"""

from __future__ import annotations

import ctypes

import torch

from lidal_tpu_torch import kernels_build
from lidal_tpu_torch.ops.cuda_conv import _PLAIN_CHUNK
from lidal_tpu_torch.utils import profiling

_PAIRS_PER_STAGE = 64  # pairs a dwg block stages at a time (kStage in the source)
_SEG_ROWS = 4096  # rows of the map a list block scans (kSegRows in the source)
_MIN_CHUNK_PAIRS = 1024  # fewer chunks a tap: the grid's blocks past a tap's count still cost a launch
_WORKSPACE_BYTES = 256 << 20  # bound on the partials [K, S, c_f, c_src]


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


def pair_chunks(m: int, k: int, c_f: int, c_src: int, stage: int = _PAIRS_PER_STAGE):
    """(S, pairs per chunk P) of the kernel's weight-gradient reduction.

    A tap's list of real pairs is cut into chunks of P pairs, P a multiple of
    the ``stage`` (64 pairs here, 128 in the bf16 kernel of
    ``cuda_conv_dxdw_fused``), and the grid holds S = ceil(m / P) chunks a tap (the
    worst case: every row real; blocks past the count exit).  P depends on
    the shape only, so a shape always sums in the same order.  P is
    ``_MIN_CHUNK_PAIRS``, or more where the partials' workspace [K, S, c_f,
    c_src] would not fit in ``_WORKSPACE_BYTES``.  (At level 0 the real
    pairs are ~4 % of the worst case: chunks of 256 or 512 pairs gave more
    busy blocks but measured slower, the empty ones costing more.)"""
    if m == 0:
        return 1, stage
    s_cap = max(1, _WORKSPACE_BYTES // (4 * k * c_f * c_src))
    p = _cdiv(max(_MIN_CHUNK_PAIRS, _cdiv(m, s_cap)), stage) * stage
    return _cdiv(m, p), p


def pair_lists_plain(nbr_t, n: int):
    """Plain torch version of the kernel's per-tap lists of real pairs.

    For a map transposed, nbr_t int32 [K, m] (sentinel: any index outside
    [0, n)), returns (rows int32 [K, m], counts int32 [K]): rows[k,
    :counts[k]] are the rows i with a real nbr_t[k, i], ascending; the rest of
    each row holds m.  :func:`conv_dx_dw` builds the same lists inside its
    launch (the tail of each row left unwritten)."""
    k, m = nbr_t.shape
    real = (nbr_t >= 0) & (nbr_t < n)
    counts = real.sum(1, dtype=torch.int32)
    order = torch.sort((~real).to(torch.uint8), dim=1, stable=True).indices
    first = torch.arange(m, device=nbr_t.device)[None, :] < counts[:, None]
    return torch.where(first, order, m).to(torch.int32), counts


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
    chunks, per_chunk = pair_chunks(m, k, c_f, c_src)
    dev = src.device
    dx = torch.empty((m, c_dst), dtype=torch.float32, device=dev) if need_dx else None
    dwg = torch.empty((k, c_f, c_src), dtype=torch.float32, device=dev)
    ws = torch.empty((k, chunks, c_f, c_src), dtype=torch.float32, device=dev) if chunks > 1 else dwg
    nbr_t = nbr.t().contiguous()
    rows = torch.empty((k, m), dtype=torch.int32, device=dev)  # the pair lists, built by the launch
    counts = torch.empty(k, dtype=torch.int32, device=dev)
    seg_counts = torch.empty((k, max(1, _cdiv(m, _SEG_ROWS))), dtype=torch.int32, device=dev)
    fn = kernels_build.function(
        "conv_dx_dw", "lidal_conv_dx_dw", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    with torch.cuda.device(dev):
        err = fn(
            src.data_ptr(), w2.data_ptr(), nbr.data_ptr(), nbr_t.data_ptr(), f.data_ptr(),
            dx.data_ptr() if need_dx else None, dwg.data_ptr(), ws.data_ptr(),
            rows.data_ptr(), counts.data_ptr(), seg_counts.data_ptr(),
            m, n, k, c_src, c_dst, c_f, chunks, per_chunk, int(need_dx),
            torch.cuda.current_stream().cuda_stream,
        )
    profiling.count("launch.conv_dx_dw")
    kernels_build.check(err, "conv_dx_dw")
    return dx, dwg
