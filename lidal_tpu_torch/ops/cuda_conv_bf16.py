"""Gather-first bf16 conv kernels (``csrc/conv_gather_first.cu``) and their plain
versions.

``conv_gather_first`` replaces ``tools/probe_conv_v3.py:subm_conv_v3`` and
``conv_byte_planes`` replaces ``tools/probe_int8_gather.py:subm_conv_i8``.
Both compute ``ops/cuda_conv.subm_conv`` without its epilogue on operands
rounded to bf16, with f32 sums; the second reads the feature table as two int8
byte planes of the bf16 bit patterns, a lossless re-encoding, and is bit-equal
to the first.  A CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain version: the operands cast to bf16 and back to f32, then
``subm_conv_plain``.

The kernel takes input channels in multiples of ``CIN_ALIGN`` = 16 (one
``mma.sync`` step, and 16-byte ``cp.async`` pieces of a bf16 row).  The
wrappers zero-pad the table's and the weights' input channels up to it, so
the stem's cin = 4 is gathered as 32-byte rows.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lidal_tpu_torch import kernels_build
from lidal_tpu_torch.ops.cuda_conv import subm_conv_plain

# Kernel launches since import (or since a caller reset them).
GATHER_FIRST_LAUNCHES = 0
BYTE_PLANES_LAUNCHES = 0

CIN_ALIGN = 16


def _cin_pad(cin: int) -> int:
    return -(-cin // CIN_ALIGN) * CIN_ALIGN


def pack_table(feats: torch.Tensor) -> torch.Tensor:
    """feats [n, cin] rounded to bf16, input channels zero-padded to ``CIN_ALIGN``."""
    table = feats.to(torch.bfloat16)
    pad = _cin_pad(table.shape[1]) - table.shape[1]
    return (F.pad(table, (0, pad)) if pad else table).contiguous()


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """w [K, cin, cout] rounded to bf16 as [K, cout, cin_pad]: the kernel reads
    a column's input channels contiguously."""
    wt = w.to(torch.bfloat16)
    pad = _cin_pad(wt.shape[1]) - wt.shape[1]
    if pad:
        wt = F.pad(wt, (0, 0, 0, pad))
    return wt.transpose(1, 2).contiguous()


def to_byte_planes(feats: torch.Tensor) -> torch.Tensor:
    """int8 [n, 2 * cin_pad]: the low bytes of the bf16 bit patterns of
    ``feats`` [n, cin], then their high bytes.  ``cin_pad`` is cin rounded up
    to ``CIN_ALIGN`` = 16 (padded channels are zero)."""
    bits = pack_table(feats).view(torch.int16).to(torch.int32) & 0xFFFF
    planes = torch.cat([bits & 0xFF, bits >> 8], dim=1)
    return planes.to(torch.uint8).view(torch.int8)


def from_byte_planes(planes: torch.Tensor) -> torch.Tensor:
    """bf16 [n, cin_pad] rebuilt bit for bit: ``(hi & 0xFF) << 8 | (lo & 0xFF)``."""
    cin_pad = planes.shape[1] // 2
    b = planes.to(torch.int32) & 0xFF  # int8 sign-extends: mask before the shift
    bits = (b[:, cin_pad:] << 8) | b[:, :cin_pad]
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)  # into int16's range, the same 16 bits
    return bits.to(torch.int16).view(torch.bfloat16)


def _check(cin: int, w, nbr, what: str, padded: bool = False) -> None:
    """``cin``: the table's input channels (``padded``: of byte planes, rounded up)."""
    if w.dim() != 3 or nbr.dim() != 2:
        raise ValueError(f"w [K, cin, cout] and nbr [m, K] expected, got {tuple(w.shape)}, {tuple(nbr.shape)}")
    if w.shape[0] != nbr.shape[1] or cin != (_cin_pad(w.shape[1]) if padded else w.shape[1]):
        raise ValueError(f"w {tuple(w.shape)} does not fit {what} and nbr {tuple(nbr.shape)}")


def conv_gather_first_plain(feats, w, nbr, pipelined: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`conv_gather_first` (same arguments;
    ``pipelined`` changes no value)."""
    if feats.dim() != 2:
        raise ValueError(f"feats [n, cin] expected, got {tuple(feats.shape)}")
    _check(feats.shape[1], w, nbr, f"feats {tuple(feats.shape)}")
    return subm_conv_plain(feats.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(), nbr)


def conv_byte_planes_plain(planes, w, nbr) -> torch.Tensor:
    """Plain torch version of :func:`conv_byte_planes` (same arguments)."""
    if planes.dim() != 2 or planes.dtype != torch.int8 or planes.shape[1] % (2 * CIN_ALIGN):
        raise ValueError(f"planes int8 [n, 2 * cin_pad] expected, got {planes.dtype} {tuple(planes.shape)}")
    _check(planes.shape[1] // 2, w, nbr, f"planes {tuple(planes.shape)}", padded=True)
    feats = from_byte_planes(planes)[:, : w.shape[1]].float()
    return subm_conv_plain(feats, w.to(torch.bfloat16).float(), nbr)


def _launch(table, wt, nbr, planes: bool, pipelined: bool) -> torch.Tensor:
    dev = table.device
    k, cout, cin = wt.shape
    row = 2 * cin if planes else cin
    for name, x, dtype in (("the table", table, torch.int8 if planes else torch.bfloat16),
                           ("the packed weights", wt, torch.bfloat16), ("nbr", nbr, torch.int32)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}")
    if table.dim() != 2 or table.shape[1] != row or nbr.dim() != 2 or nbr.shape[1] != k:
        raise ValueError(f"table {tuple(table.shape)}, packed weights {tuple(wt.shape)} and nbr {tuple(nbr.shape)} do not fit")
    if k > 27 or cin % CIN_ALIGN or cout % 32:
        raise ValueError(f"the gather-first kernel needs K <= 27, cin % 16 == 0, cout % 32 == 0; got {k}, {cin}, {cout}")
    if table.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("the table and the weights must be 16-byte aligned (cp.async)")
    m, n = nbr.shape[0], table.shape[0]
    out = torch.empty((m, cout), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    fn = kernels_build.function(
        "conv_gather_first", "lidal_conv_gather_first", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), wt.data_ptr(), nbr.data_ptr(), out.data_ptr(), m, n, k, cin, cout,
                 int(planes), int(pipelined), torch.cuda.current_stream().cuda_stream)
    global GATHER_FIRST_LAUNCHES, BYTE_PLANES_LAUNCHES
    with kernels_build.LAUNCH_LOCK:
        if planes:
            BYTE_PLANES_LAUNCHES += 1
        else:
            GATHER_FIRST_LAUNCHES += 1
    kernels_build.check(err, "conv_byte_planes" if planes else "conv_gather_first")
    return out


def gather_first_packed(table, wt, nbr, pipelined: bool = False) -> torch.Tensor:
    """The kernel on operands already packed by :func:`pack_table` and
    :func:`pack_weights` (CUDA tensors only)."""
    if table.device.type != "cuda":
        raise ValueError(f"gather_first_packed launches the CUDA kernel, got a tensor on {table.device}")
    return _launch(table, wt, nbr, False, pipelined)


def byte_planes_packed(planes, wt, nbr) -> torch.Tensor:
    """The kernel on byte planes and weights packed by :func:`pack_weights`
    (CUDA tensors only)."""
    if planes.device.type != "cuda":
        raise ValueError(f"byte_planes_packed launches the CUDA kernel, got a tensor on {planes.device}")
    return _launch(planes, wt, nbr, True, False)


def conv_gather_first(feats, w, nbr, pipelined: bool = False) -> torch.Tensor:
    """out[i] = sum_k bf16(feats)[nbr[i, k]] @ bf16(w)[k], f32 sums; an index
    outside [0, n) gives 0; map columns in any order.

    The gathered rows of a group of taps are assembled first and contracted
    once; ``pipelined`` stages the next group while this one is contracted and
    gives bit-equal output.

    Args:
      feats: f32 [n, cin].
      w: f32 [K, cin, cout], K <= 27, cout % 32 == 0.
      nbr: int32 [m, K] source rows (sentinel n).
    """
    if feats.device.type == "cpu":
        return conv_gather_first_plain(feats, w, nbr, pipelined)
    if feats.device.type != "cuda":
        raise ValueError(f"conv_gather_first runs on CPU or CUDA tensors, got {feats.device}")
    if feats.dim() != 2 or feats.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"feats f32 [n, cin] and w f32 expected, got {feats.dtype} {tuple(feats.shape)}, {w.dtype}")
    _check(feats.shape[1], w, nbr, f"feats {tuple(feats.shape)}")
    return gather_first_packed(pack_table(feats), pack_weights(w), nbr, pipelined)


def conv_byte_planes(planes, w, nbr) -> torch.Tensor:
    """:func:`conv_gather_first` with the feature table given as
    ``to_byte_planes(feats)``: each gathered value is rebuilt bit for bit from
    its two bytes, so the output is bit-equal to ``conv_gather_first(feats, w,
    nbr)``.

    Args:
      planes: int8 [n, 2 * cin_pad] from :func:`to_byte_planes`.
      w: f32 [K, cin, cout], cin <= cin_pad < cin + 16.
      nbr: int32 [m, K] source rows (sentinel n).
    """
    if planes.device.type == "cpu":
        return conv_byte_planes_plain(planes, w, nbr)
    if planes.device.type != "cuda":
        raise ValueError(f"conv_byte_planes runs on CPU or CUDA tensors, got {planes.device}")
    if planes.dim() != 2 or planes.dtype != torch.int8 or planes.shape[1] % (2 * CIN_ALIGN) or w.dtype != torch.float32:
        raise ValueError(f"planes int8 [n, 2 * cin_pad] and w f32 expected, got {planes.dtype} {tuple(planes.shape)}, {w.dtype}")
    _check(planes.shape[1] // 2, w, nbr, f"planes {tuple(planes.shape)}", padded=True)
    return byte_planes_packed(planes, pack_weights(w), nbr)
