"""Gather-first bf16 conv kernels (``csrc/conv_gather_first.cu``) and their plain
versions.

``conv_gather_first`` is the forward of the bf16 route (``ops/conv.py``,
``BF16_OPERANDS``): there it takes the place of
``lidal_tpu/ops/pallas_conv.py:subm_conv_pallas`` in every conv of MinkUNet
and SPVCNN, with the eval-BN epilogue (``scale``, ``shift``, ``relu`` and
the row-valid mask of ``pallas_conv.py:162-166``) in inference.  It also
replaces ``tools/probe_conv_v3.py:subm_conv_v3``, and ``conv_byte_planes``
replaces ``tools/probe_int8_gather.py:subm_conv_i8``.  Both compute
``ops/cuda_conv.subm_conv`` on operands rounded to bf16, with f32 sums (the
epilogue on the f32 sums, bf16 table only); the second reads the feature
table as two int8 byte planes of the bf16 bit patterns, a lossless
re-encoding, and is bit-equal to the first.  A CUDA tensor launches the
kernel or raises; a CPU tensor takes the plain version: the operands cast to
bf16 and back to f32, then ``subm_conv_plain``.

The kernel is the bf16 gather-GEMM tile of ``csrc/gather_gemm_bf16.cuh``:
row tiles of 64 rows a warpgroup (:func:`tile_rows`), the active taps of a
tile only, stages of 64 (tap, channel) columns gathered by ``cp.async`` into a
ring in shared memory and contracted by ``wgmma``.  :func:`column_tile` and
:func:`ring_stages` choose its column tile and ring depth (``pipelined`` picks
the deeper ring; the output is bit-equal), :func:`tile_products` counts the
products it issues on a map.  What bounds it on an H100 is L2's bandwidth
for the gathered pieces and the weights (200-225 TFLOP/s on the probe's dense
level-0 maps), and on sparse maps the products of active taps on rows without
a real pair.  It takes input channels in multiples of ``CIN_ALIGN`` = 16; the
wrappers zero-pad the table's and the weights' input channels up to it, so
the stem's cin = 4 is gathered as 32-byte rows.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lidal_tpu_torch import kernels_build
from lidal_tpu_torch.ops.cuda_conv import subm_conv_plain
from lidal_tpu_torch.utils import profiling

CIN_ALIGN = 16
STAGE_COLS = 64  # (tap, channel) columns of a stage (kKS in gather_gemm_bf16.cuh)
COLUMN_TILES = (128, 96, 64, 32)  # widest first
SHALLOW_STAGES = 4  # the ring without ``pipelined``
MAX_STAGES = 8  # kMaxStages
_SMEM_MAX = 232448  # dynamic shared memory a block may ask for on sm_90 (kSmemMax)
_TAPS = 27  # kKMax: the tile's map in shared memory has a row per tap
BIG_TILE_BLOCKS = 200


def column_tile(cout: int) -> int:
    """The kernel's column tile for ``cout`` (a multiple of 32): the widest of
    128, 96, 64 and 32 that divides it."""
    for bn in COLUMN_TILES:
        if cout % bn == 0:
            return bn
    raise ValueError(f"cout must be a multiple of 32, got {cout}")


def tile_rows(bn: int, m: int, cout: int) -> int:
    """Rows of the kernel's tile, 64 a consumer warpgroup: 192 at column tile
    ``bn`` >= 96 where that still makes ``BIG_TILE_BLOCKS`` blocks (1.5 waves
    on 132 SMs; the weights of a stage then serve 192 rows, not 128), else
    128."""
    return 192 if bn >= 96 and -(-m // 192) * (cout // bn) >= BIG_TILE_BLOCKS else 128


def smem_bytes(bn: int, rows: int, stages: int) -> int:
    """Dynamic shared memory of the tile (``Ring::smem``): the tile's map and
    tap list rounded up to 1024 bytes, the stages of (rows + bn) x 64 bf16,
    and 1024 bytes of alignment."""
    header = -(-(_TAPS * rows + 65) * 4 // 1024) * 1024
    return header + stages * (rows + bn) * STAGE_COLS * 2 + 1024


def ring_stages(bn: int, rows: int, pipelined: bool) -> int:
    """Depth of the kernel's ring of stages: 4, or with ``pipelined`` the
    deepest (at most 8) that fits an SM's shared memory."""
    if not pipelined:
        return SHALLOW_STAGES
    return max(s for s in range(SHALLOW_STAGES, MAX_STAGES + 1) if smem_bytes(bn, rows, s) <= _SMEM_MAX)


def tile_products(nbr: torch.Tensor, n: int, cin: int, cout: int) -> int:
    """Multiply-adds the kernel issues on map ``nbr`` [m, K] with ``cin``
    (padded) input channels: per row tile, its stages of 64 columns over the
    taps that are real somewhere in it, times the tile's rows and ``cout``."""
    m, k = nbr.shape
    rows = tile_rows(column_tile(cout), m, cout)
    real = ((nbr >= 0) & (nbr < n)).to(torch.int32)
    real = torch.cat([real, real.new_zeros(((-m) % rows, k))]).reshape(-1, rows, k)
    active = real.amax(1).sum(1).long()
    stages = (active * cin + STAGE_COLS - 1) // STAGE_COLS
    return int(stages.sum()) * STAGE_COLS * rows * cout


def _cin_pad(cin: int) -> int:
    return -(-cin // CIN_ALIGN) * CIN_ALIGN


def bf16_padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """x [rows, c] rounded to bf16, contiguous, its columns zero-padded to ``width``."""
    xb = x.to(torch.bfloat16)
    return (F.pad(xb, (0, width - x.shape[1])) if width != x.shape[1] else xb).contiguous()


def pack_table(feats: torch.Tensor) -> torch.Tensor:
    """feats [n, cin] rounded to bf16, input channels zero-padded to ``CIN_ALIGN``."""
    return bf16_padded(feats, _cin_pad(feats.shape[1]))


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


def _check_epilogue(scale, shift, cout: int) -> None:
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if scale is not None and (scale.shape != (cout,) or shift.shape != (cout,)):
        raise ValueError(f"scale/shift must be [{cout}], got {tuple(scale.shape)}, {tuple(shift.shape)}")


def conv_gather_first_plain(feats, w, nbr, pipelined: bool = False, scale=None, shift=None,
                            relu: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`conv_gather_first` (same arguments;
    ``pipelined`` changes no value)."""
    if feats.dim() != 2:
        raise ValueError(f"feats [n, cin] expected, got {tuple(feats.shape)}")
    _check(feats.shape[1], w, nbr, f"feats {tuple(feats.shape)}")
    return subm_conv_plain(feats.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(), nbr, scale, shift, relu)


def conv_byte_planes_plain(planes, w, nbr) -> torch.Tensor:
    """Plain torch version of :func:`conv_byte_planes` (same arguments)."""
    if planes.dim() != 2 or planes.dtype != torch.int8 or planes.shape[1] % (2 * CIN_ALIGN):
        raise ValueError(f"planes int8 [n, 2 * cin_pad] expected, got {planes.dtype} {tuple(planes.shape)}")
    _check(planes.shape[1] // 2, w, nbr, f"planes {tuple(planes.shape)}", padded=True)
    feats = from_byte_planes(planes)[:, : w.shape[1]].float()
    return subm_conv_plain(feats, w.to(torch.bfloat16).float(), nbr)


def _launch(table, wt, nbr, planes: bool, pipelined: bool, scale=None, shift=None, relu: bool = False) -> torch.Tensor:
    dev = table.device
    k, cout, cin = wt.shape
    row = 2 * cin if planes else cin
    args = [("the table", table, torch.int8 if planes else torch.bfloat16), ("the packed weights", wt, torch.bfloat16),
            ("nbr", nbr, torch.int32)]
    _check_epilogue(scale, shift, cout)
    if scale is not None:
        if planes:
            raise ValueError("the byte planes take no epilogue")
        args += [("scale", scale, torch.float32), ("shift", shift, torch.float32)]
    for name, x, dtype in args:
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
    bn = column_tile(cout)
    rows = tile_rows(bn, m, cout)
    epilogue = 0 if scale is None else (2 if relu else 1)
    fn = kernels_build.function(
        "conv_gather_first", "lidal_conv_gather_first", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    )
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), wt.data_ptr(), nbr.data_ptr(), scale.data_ptr() if scale is not None else None,
                 shift.data_ptr() if shift is not None else None, out.data_ptr(), m, n, k, cin, cout, int(planes),
                 epilogue, bn, rows, ring_stages(bn, rows, pipelined), torch.cuda.current_stream().cuda_stream)
    profiling.count("launch.conv_byte_planes" if planes else "launch.conv_gather_first")
    kernels_build.check(err, "conv_byte_planes" if planes else "conv_gather_first")
    return out


def gather_first_packed(table, wt, nbr, pipelined: bool = False, scale=None, shift=None,
                        relu: bool = False) -> torch.Tensor:
    """The kernel on operands already packed by :func:`pack_table` and
    :func:`pack_weights` (CUDA tensors only)."""
    if table.device.type != "cuda":
        raise ValueError(f"gather_first_packed launches the CUDA kernel, got a tensor on {table.device}")
    return _launch(table, wt, nbr, False, pipelined, scale, shift, relu)


def byte_planes_packed(planes, wt, nbr) -> torch.Tensor:
    """The kernel on byte planes and weights packed by :func:`pack_weights`
    (CUDA tensors only)."""
    if planes.device.type != "cuda":
        raise ValueError(f"byte_planes_packed launches the CUDA kernel, got a tensor on {planes.device}")
    return _launch(planes, wt, nbr, True, False)


def conv_gather_first(feats, w, nbr, pipelined: bool = False, scale=None, shift=None,
                      relu: bool = False) -> torch.Tensor:
    """out[i] = sum_k bf16(feats)[nbr[i, k]] @ bf16(w)[k], f32 sums; an index
    outside [0, n) gives 0; map columns in any order.

    With ``scale``/``shift`` ([cout], f32) the eval-BN epilogue follows on the
    f32 sums: ``y = out * scale + shift``, ``relu`` if asked, then 0 on rows
    with no real tap.

    The gathered rows of each row tile are assembled in shared memory
    first, in stages of 64 (tap, channel) columns over the tile's active taps,
    and contracted by ``wgmma``; ``pipelined`` gives the ring of stages its
    deepest size and bit-equal output.  The wrapper casts ``feats`` and ``w``
    to bf16 tables at each call, as the JAX route does.

    Args:
      feats: f32 [n, cin].
      w: f32 [K, cin, cout], K <= 27, cout % 32 == 0.
      nbr: int32 [m, K] source rows (sentinel n).
    """
    if feats.device.type == "cpu":
        return conv_gather_first_plain(feats, w, nbr, pipelined, scale, shift, relu)
    if feats.device.type != "cuda":
        raise ValueError(f"conv_gather_first runs on CPU or CUDA tensors, got {feats.device}")
    if feats.dim() != 2 or feats.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"feats f32 [n, cin] and w f32 expected, got {feats.dtype} {tuple(feats.shape)}, {w.dtype}")
    _check(feats.shape[1], w, nbr, f"feats {tuple(feats.shape)}")
    return gather_first_packed(pack_table(feats), pack_weights(w), nbr, pipelined, scale, shift, relu)


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
