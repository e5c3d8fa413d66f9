"""Weighted 8-tap gather, its transpose and the child-sum chain
(``csrc/gather8.cu``) with their plain versions: the point<->voxel transfers
of SPVCNN.

Replaces ``lidal_tpu/ops/pallas_gather8.py``: ``gather8_pallas``,
``scatter8_pallas`` and the ``custom_vjp`` ``gather8`` around them, and the
chain of ``gather8_pallas`` calls of ``lidal_tpu/ops/devoxelize.py:_child_sum``.

    gather8:    out[i]    = sum_{k < 8} w8[i, k] * feats[nbr[i, k]]
    scatter8:   dfeats[t] = sum_{(i, k): nbr[i, k] == t} w8[i, k] * dy[i]
    child_sum:  the levels' 8-tap child sums (weights 1) one after another,
                divided by max(counts, 1), in one launch

An index outside ``[0, n)`` is the sentinel and contributes zero; map columns
need not be sorted.  A CUDA tensor launches the kernel; a CPU tensor takes the
plain version.  ``gather8`` is bit-equal to :func:`gather8_plain` (the same
products and sums in the same order, each rounded on its own).  ``scatter8``
builds its transposed map on the card (integer atomics, then a sort of each
target's segment, so the map equals :func:`build_transpose`'s) and sums
without float atomics in an order the map fixes, so it gives the same bits on
every run; :func:`scatter8_plain` is ``index_add_``, whose order on a card is
not fixed, so the two agree within a tolerance scaled by ``sum |w8| |dy|`` per
target.  ``child_sum`` is bit-equal to :func:`child_sum_plain`, the levels
run one after another.

The bf16 route rounds what the TPU kernels round.  Every wrapper takes the
route as an argument and reads no switch of its own: ``ops/devoxelize.py``
passes ``ops/conv.BF16_OPERANDS``, the route's one switch (the JAX package's
``conv.USE_PALLAS`` and ``pallas_gather8.USE_PALLAS_BWD`` set together).
``bf16_table=True`` of :func:`gather8_forward` reads ``feats`` as bf16
(``pallas_gather8.py:139``; ``w8`` stays f32, the one-hot of ``:105-106`` is
exact), as the JAX package's ``devoxelize.py:126-133`` does under
``conv.USE_PALLAS``; ``bf16=True`` of :func:`child_sum` reads the points and
each level's sums as bf16, as the JAX chain casts the table of each of its
``gather8_pallas`` calls; ``bf16=True`` of :func:`scatter8` reads ``dy`` as
bf16 and rounds ``w8`` to bf16 (``:314`` and the weighted one-hot of
``:284``).  ``bf16=True`` of :func:`gather8` asks for both: the bf16 table
forward and the bf16 ``scatter8`` backward.  The kernels take the f32 rows
and round each value in registers, which gives the bits of a cast without a
bf16 copy; the products and sums stay f32 in the same order, and the plain
versions round the same operands.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from lidal_tpu_torch import kernels_build
from lidal_tpu_torch.utils import profiling

TAPS = 8

_MAX_SCATTER_C = 1024  # a warp covers a row in at most 8 float4 slices a lane
_MAX_CHAIN_C = 512  # the chain's warp keeps a row in at most 4 float4 slices a lane
_MAX_CHAIN_LEVELS = 4


def _check(rows, nbr, w8) -> None:
    if rows.dim() != 2 or nbr.dim() != 2 or nbr.shape[1] != TAPS or w8.shape != nbr.shape:
        raise ValueError(
            f"rows [., c], nbr [m, {TAPS}] and w8 [m, {TAPS}] expected, got "
            f"{tuple(rows.shape)}, {tuple(nbr.shape)}, {tuple(w8.shape)}"
        )


def _check_cuda(what: str, rows, nbr, w8) -> None:
    """``rows`` f32 on both routes: the route's kernels round them as they read."""
    for name, x, dtype in ((what, rows, torch.float32), ("nbr", nbr, torch.int32), ("w8", w8, torch.float32)):
        if x.device != rows.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {rows.device}")
    if rows.shape[1] % 4 or rows.data_ptr() % 16:
        raise ValueError(f"the kernel needs c % 4 == 0 and rows aligned to 4 values (vector loads); c = {rows.shape[1]}")
    if nbr.numel() >= 2**31:
        raise ValueError(f"the map has {nbr.numel()} (row, tap) pairs, the kernel indexes them in 32 bits")


def _safe_index(nbr: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where((nbr >= 0) & (nbr < n), nbr, n).long()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def gather8_plain(feats: torch.Tensor, nbr: torch.Tensor, w8: torch.Tensor, bf16_table: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`gather8_forward`: an explicit loop over
    the taps in ascending k, a product and a sum per tap (no ``einsum``, whose
    order is the library's), so the kernel can match it bit for bit."""
    _check(feats, nbr, w8)
    if bf16_table:
        feats = _bf16(feats)
    n = feats.shape[0]
    fx = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
    idx = _safe_index(nbr, n)
    w = w8.to(feats.dtype)
    out = feats.new_zeros((nbr.shape[0], feats.shape[1]))
    for k in range(TAPS):
        out += w[:, k, None] * fx[idx[:, k]]
    return out


def gather8_forward(feats: torch.Tensor, nbr: torch.Tensor, w8: torch.Tensor, bf16_table: bool = False) -> torch.Tensor:
    """out[i] = sum_k w8[i, k] * feats[nbr[i, k]], f32 [m, c]; no gradient.
    With ``bf16_table`` the kernel rounds each value of ``feats`` to bf16 as
    it reads it (no copy of the table).

    Args:
      feats: f32 [n, c], c % 4 == 0 on a card.
      nbr: int32 [m, 8] source rows (sentinel n), columns in any order.
      w8: f32 [m, 8] weights.
    """
    if feats.device.type == "cpu":
        return gather8_plain(feats, nbr, w8, bf16_table)
    if feats.device.type != "cuda":
        raise ValueError(f"gather8 runs on CPU or CUDA tensors, got {feats.device}")
    _check(feats, nbr, w8)
    _check_cuda("feats", feats, nbr, w8)
    n, c = feats.shape
    m = nbr.shape[0]
    out = torch.empty((m, c), dtype=torch.float32, device=feats.device)
    if m * c == 0:
        return out
    fn = kernels_build.function(
        "gather8", "lidal_gather8", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    with torch.cuda.device(feats.device):
        err = fn(feats.data_ptr(), nbr.data_ptr(), w8.data_ptr(), out.data_ptr(), m, n, c, int(bf16_table),
                 torch.cuda.current_stream().cuda_stream)
    profiling.count("launch.gather8_bf16" if bf16_table else "launch.gather8")
    kernels_build.check(err, "gather8")
    return out


def scatter8_plain(dy: torch.Tensor, nbr: torch.Tensor, w8: torch.Tensor, n: int, bf16: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`scatter8`: the ``[m, 8, c]`` weighted
    cotangent added into its targets by ``index_add_``, sentinels dropped (the
    form the JAX package uses off the TPU)."""
    _check(dy, nbr, w8)
    if bf16:
        dy, w8 = _bf16(dy), _bf16(w8)
    c = dy.shape[1]
    contrib = (w8.to(dy.dtype)[:, :, None] * dy[:, None, :]).reshape(-1, c)
    out = dy.new_zeros((n + 1, c))
    out.index_add_(0, _safe_index(nbr, n).reshape(-1), contrib)
    return out[:n]


def build_transpose(nbr: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The map seen from its targets (plain version of :func:`transpose_map`):
    ``order`` int32 [m * 8], the (row, tap) pairs ``i * 8 + k`` sorted by
    target (stable, so a target's pairs ascend; sentinels last), and
    ``offsets`` int32 [n + 1]: target t owns ``order[offsets[t]:offsets[t + 1]]``.
    Integer sorting and searching only, so the result is the same on every run."""
    key = torch.where((nbr >= 0) & (nbr < n), nbr, n).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    targets = torch.arange(n + 1, dtype=key.dtype, device=key.device)
    offsets = torch.searchsorted(sorted_key, targets, out_int32=True)
    return order.to(torch.int32), offsets


def _map_scratch(nbr: torch.Tensor, n: int):
    """(counts, offsets [n + 1], order [m * 8], tmp [m * 8]) int32 views of one
    device allocation: the scratch of the map kernels (counts holds the
    per-target counts, the list of long segments and the scan's tile sums:
    2 n + 2 + n // 4096 entries)."""
    m8 = nbr.numel()
    c = 2 * n + 2 + n // 4096
    ws = torch.empty(c + n + 1 + 2 * m8, dtype=torch.int32, device=nbr.device)
    return ws[:c], ws[c : c + n + 1], ws[c + n + 1 : c + n + 1 + m8], ws[c + n + 1 + m8 :]


def transpose_map(nbr: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, offsets)`` of :func:`build_transpose`, built on a card by the
    kernels that :func:`scatter8` runs first (count, scan, fill, segment sort),
    with no host sync.  ``offsets`` and ``order[:offsets[n]]`` equal
    :func:`build_transpose`'s; the rest of ``order`` is scratch.  For checks:
    :func:`scatter8` builds its map in the same call as its sum."""
    if nbr.device.type == "cpu":
        return build_transpose(nbr, n)
    if nbr.device.type != "cuda":
        raise ValueError(f"transpose_map runs on CPU or CUDA tensors, got {nbr.device}")
    if nbr.dim() != 2 or nbr.shape[1] != TAPS or nbr.dtype != torch.int32 or not nbr.is_contiguous():
        raise ValueError(f"nbr must be a contiguous int32 [m, {TAPS}] tensor, got {nbr.dtype} {tuple(nbr.shape)}")
    if nbr.numel() >= 2**31 or n >= 2**31 - 1:
        raise ValueError(f"the map kernels index pairs and targets in 32 bits (m * 8 = {nbr.numel()}, n = {n})")
    counts, offsets, order, tmp = _map_scratch(nbr, n)
    fn = kernels_build.function("gather8", "lidal_transpose8", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    with torch.cuda.device(nbr.device):
        err = fn(nbr.data_ptr(), counts.data_ptr(), offsets.data_ptr(), order.data_ptr(), tmp.data_ptr(),
                 nbr.shape[0], n, torch.cuda.current_stream().cuda_stream)
    kernels_build.check(err, "transpose_map")
    return order, offsets


def scatter8(dy: torch.Tensor, nbr: torch.Tensor, w8: torch.Tensor, n: int, bf16: bool = False) -> torch.Tensor:
    """dfeats[t] = sum over the pairs with nbr[i, k] == t of w8[i, k] * dy[i],
    f32 [n, c]: the gradient of :func:`gather8` with respect to ``feats``.
    With ``bf16`` the kernel rounds each value of ``dy`` and ``w8`` to bf16
    as it reads it (no copy of ``dy``).

    Args:
      dy: f32 [m, c], c % 4 == 0 and c <= 1024 on a card.
      nbr: int32 [m, 8] target rows (sentinel n), columns in any order.
      w8: f32 [m, 8] weights.
      n: rows of the result.
    """
    if dy.device.type == "cpu":
        return scatter8_plain(dy, nbr, w8, n, bf16)
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
    counts, offsets, order, tmp = _map_scratch(nbr, n)
    fn = kernels_build.function(
        "gather8", "lidal_scatter8", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    with torch.cuda.device(dy.device):
        err = fn(dy.data_ptr(), w8.data_ptr(), nbr.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
                 order.data_ptr(), tmp.data_ptr(), out.data_ptr(), nbr.shape[0], n, c, int(bf16),
                 torch.cuda.current_stream().cuda_stream)
    profiling.count("launch.scatter8_bf16" if bf16 else "launch.scatter8")
    kernels_build.check(err, "scatter8")
    return out


def _flatten_children(child: torch.Tensor, cap_f: int) -> torch.Tensor:
    """[B, cap_c, 8] per-frame child rows -> [B * cap_c, 8] rows of the
    stacked level (sentinel B * cap_f for anything outside [0, cap_f))."""
    b = child.shape[0]
    off = (torch.arange(b, dtype=torch.int32, device=child.device) * cap_f)[:, None, None]
    real = (child >= 0) & (child < cap_f)
    return torch.where(real, child + off, b * cap_f).to(torch.int32).reshape(-1, TAPS)


def child_sum_plain(x: torch.Tensor, children: Sequence[torch.Tensor], counts: torch.Tensor,
                    bf16: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`child_sum`: one :func:`gather8_plain`
    with weights 1 per level (the JAX package's chain of ``gather8`` calls,
    each level's table rounded to bf16 with ``bf16``), then the divide."""
    b = x.shape[0]
    for child in children:
        nbr = _flatten_children(child, x.shape[1])
        ones = torch.ones(nbr.shape, dtype=torch.float32, device=x.device)
        x = gather8_plain(x.reshape(-1, x.shape[-1]), nbr, ones, bf16).reshape(b, child.shape[1], -1)
    return x / counts.clamp_min(1).to(x.dtype)[..., None]


def child_sum(x: torch.Tensor, children: Sequence[torch.Tensor], counts: torch.Tensor,
              bf16: bool = False) -> torch.Tensor:
    """The average of the points under each voxel of level L = len(children):
    out[b, o] = (sum of x over the subtree of o) / max(counts[b, o], 1), f32
    [B, cap_L, c]; no gradient.  The sums are those of the chain of 8-tap
    child sums, level by level in ascending child order; with ``bf16`` the
    kernel rounds the points and each level's sums to bf16 before the next
    level adds them, as the route's chain rounds each level's table.

    Args:
      x: f32 [B, cap_0, c], c % 4 == 0 and c <= 512 on a card.
      children: 1-4 int32 maps; children[l] [B, cap_{l+1}, 8] holds the rows
        of level l under each row of level l + 1 (sentinel: outside [0, cap_l)).
      counts: int32 [B, cap_L], the divisors (0 divides by 1).
    """
    if x.device.type == "cpu":
        return child_sum_plain(x, children, counts, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"child_sum runs on CPU or CUDA tensors, got {x.device}")
    if not 1 <= len(children) <= _MAX_CHAIN_LEVELS:
        raise ValueError(f"the chain kernel takes 1 to {_MAX_CHAIN_LEVELS} levels, got {len(children)}")
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"x must be a contiguous, 16-byte aligned f32 [B, cap, c] tensor, got {x.dtype} {tuple(x.shape)}")
    b, cap0, c = x.shape
    if c % 4 or c > _MAX_CHAIN_C:
        raise ValueError(f"the chain kernel takes c % 4 == 0 and c <= {_MAX_CHAIN_C}, got {c}")
    caps = [cap0]
    for child in children:
        if (child.dim() != 3 or child.shape[0] != b or child.shape[2] != TAPS or child.dtype != torch.int32
                or not child.is_contiguous() or child.device != x.device or child.data_ptr() % 8):
            raise ValueError(f"each child map must be a contiguous, 8-byte aligned int32 [{b}, cap, {TAPS}] tensor "
                             f"on {x.device}")
        caps.append(child.shape[1])
    if counts.shape != (b, caps[-1]) or counts.dtype != torch.int32 or not counts.is_contiguous() or counts.device != x.device:
        raise ValueError(f"counts must be a contiguous int32 [{b}, {caps[-1]}] tensor on {x.device}")
    if b * max(caps) * max(c, TAPS) >= 2**31:
        raise ValueError(f"the chain kernel indexes rows in 32 bits (B = {b}, caps {caps}, c = {c})")
    out = torch.empty((b, caps[-1], c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    maps = [child.data_ptr() for child in children] + [None] * (_MAX_CHAIN_LEVELS - len(children))
    caps_arg = caps + [0] * (_MAX_CHAIN_LEVELS + 1 - len(caps))
    fn = kernels_build.function(
        "gather8", "lidal_child_sum", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), *maps, counts.data_ptr(), out.data_ptr(), b, len(children), *caps_arg, c, int(bf16),
                 torch.cuda.current_stream().cuda_stream)
    profiling.count("launch.child_sum_bf16" if bf16 else "launch.child_sum")
    kernels_build.check(err, "child_sum")
    return out


class _Gather8(torch.autograd.Function):
    """``gather8_forward`` with ``scatter8`` as its backward.  The map and its
    weights are plan data, never parameters: both get no gradient (the JAX
    package's ``custom_vjp`` returns a zero weight cotangent by contract).
    The backward takes the forward's route."""

    @staticmethod
    def forward(ctx, feats, nbr, w8, bf16: bool):
        ctx.save_for_backward(nbr, w8)
        ctx.n = feats.shape[0]
        ctx.bf16 = bf16
        return gather8_forward(feats.contiguous(), nbr, w8, bf16)

    @staticmethod
    def backward(ctx, dy):
        nbr, w8 = ctx.saved_tensors
        return scatter8(dy.contiguous(), nbr, w8, ctx.n, ctx.bf16), None, None, None


def gather8(feats: torch.Tensor, nbr: torch.Tensor, w8: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Differentiable :func:`gather8_forward`: d/dfeats is :func:`scatter8`;
    ``nbr`` and ``w8`` get ``None``.  ``bf16`` is the route of both: the
    forward's ``bf16_table`` and the backward's ``bf16``."""
    return _Gather8.apply(feats, nbr, w8, bf16)
