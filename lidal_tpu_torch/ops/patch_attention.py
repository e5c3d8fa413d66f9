"""Attention over serialized patches (Point Transformer V3's
``SerializedAttention``, Pointcept ``point_transformer_v3m1_base.py``).

A level's valid voxels, sorted along one curve (``ops/serialize``), are cut
per frame into patches of ``k`` tokens, ``k = min(k_max, the smallest
frame's voxel count)``.  A frame of ``n`` tokens is padded to a multiple of
``k`` as Pointcept pads it: the last patch's ``r = n % k`` real tokens are
followed by the last ``k - r`` tokens of the patch before
(:func:`pad_sources`), so every patch is full and no mask is needed; after
the attention each real token is read back from its own place.  Padded cap
rows (``valid`` false) never enter.

:class:`PatchLayout` holds one level's geometry (patches, duplicated tokens,
where each padded slot reads); :func:`order_index` turns it and one curve's
order into the gather of the slots' rows and the un-pad of the result.
:func:`patch_attention` is the attention itself, ``softmax(q k^T / sqrt(d))
v`` over ``[patches, heads, k, d]`` in f32: ``F.scaled_dot_product_attention``,
on a card restricted to its memory-efficient backend (f32 operands,
``OpMultiplyAddFastF32``: three TF32 products per f32 product), which never
forms the ``k x k`` scores; no other backend is taken.  Each call counts
``launch.patch_attention``.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from lidal_tpu_torch.utils import profiling


class PatchLayout(NamedTuple):
    """One level's patches over ``B`` frames of ``cap`` rows."""

    k: int  # tokens a patch
    patches: int
    pad_tokens: int  # duplicated tokens (slots past each frame's end)
    tokens: int  # padded slots, patches * k
    src: torch.Tensor  # [tokens] int64: b * cap + the sorted place the slot reads, or -1
    start: torch.Tensor  # [B] int64: each frame's first slot
    own: torch.Tensor  # [tokens] bool: the slot is its token's own (not a duplicate)
    dup: torch.Tensor  # [B * cap] int64: the slot duplicating sorted place b * cap + s, or tokens


def pad_sources(j: torch.Tensor, n: torch.Tensor, k: int) -> torch.Tensor:
    """The sorted place padded slot ``j`` of a frame of ``n`` tokens reads:
    ``j`` itself, or past the frame's end (the last patch's ``k - r`` slots)
    the token ``k`` places back, the tail of the patch before.  ``-1`` would
    read a zero row."""
    return torch.where(j < n, j, j - k)


def patch_layout(counts: List[int], cap: int, k_max: int, device) -> PatchLayout:
    """The layout of frames holding ``counts`` valid rows (host integers):
    patches of ``k = min(k_max, the smallest non-empty frame's count)``."""
    live = [n for n in counts if n > 0]
    k = min([k_max] + live) if live else 0
    padded = [-(-n // k) * k if n > 0 else 0 for n in counts]
    tokens = sum(padded)
    starts, acc = [], 0
    for p in padded:
        starts.append(acc)
        acc += p
    b = len(counts)
    start = torch.tensor(starts, dtype=torch.int64, device=device)
    if tokens == 0:
        none = torch.zeros(0, dtype=torch.int64, device=device)
        return PatchLayout(k, 0, 0, 0, none, start, none.bool(), torch.zeros(b * cap, dtype=torch.int64,
                                                                              device=device))
    frame = torch.repeat_interleave(torch.arange(b, device=device),
                                    torch.tensor(padded, dtype=torch.int64, device=device), output_size=tokens)
    n = torch.tensor(counts, dtype=torch.int64, device=device)[frame]
    j = torch.arange(tokens, device=device) - start[frame]
    s = pad_sources(j, n, k)
    src = torch.where(s >= 0, frame * cap + s, -1)
    own = j < n
    slot = torch.arange(tokens, device=device)
    dup = torch.full((b * cap + 1,), tokens, dtype=torch.int64, device=device)
    dup[torch.where(own | (src < 0), b * cap, src)] = torch.where(own | (src < 0), tokens, slot)  # no two alike
    return PatchLayout(k, tokens // k, tokens - sum(counts), tokens, src, start, own, dup[:-1])


class OrderIndex(NamedTuple):
    """Where attention reads and writes along one order of a level."""

    gather: torch.Tensor  # [tokens] int64: the flat row ([B * cap], or B * cap for a zero row) of each slot
    unpad: torch.Tensor  # [B * cap] int64: each flat row's own slot (tokens for invalid rows, a zero row)
    dup: torch.Tensor  # [B * cap] int64: each flat row's duplicate slot, or tokens
    own_row: torch.Tensor  # [tokens] int64: the flat row a slot is the own slot of, or B * cap


def order_index(layout: PatchLayout, order: torch.Tensor, inverse: torch.Tensor, valid: torch.Tensor) -> OrderIndex:
    """``order`` / ``inverse`` [B, cap] of one curve (``serialize.sort_orders``)."""
    b, cap = order.shape
    ramp = torch.arange(b, device=order.device)[:, None] * cap
    flat = (order + ramp).reshape(-1)
    gather = torch.where(layout.src >= 0, flat[layout.src.clamp_min(0)], b * cap)
    unpad = torch.where(valid, layout.start[:, None] + inverse, layout.tokens).reshape(-1)
    dup = torch.where(valid, layout.dup[(inverse + ramp).reshape(-1)].view(b, cap), layout.tokens).reshape(-1)
    return OrderIndex(gather, unpad, dup, torch.where(layout.own, gather, b * cap))


class _Gather(torch.autograd.Function):
    """``pad(x)[index]``, the index ``len(x)`` reading a zero row; its backward
    is gathers too, ``sum_i pad(dy)[back_i]``, each ``back_i`` naming for
    every row of ``x`` one output row that read it (or ``len(dy)``: none).
    No sort and no atomics: an indexing backward would accumulate."""

    @staticmethod
    def forward(ctx, x, index, *back):
        ctx.save_for_backward(*back)
        return F.pad(x, (0, 0, 0, 1)).index_select(0, index)

    @staticmethod
    def backward(ctx, dy):
        dye = F.pad(dy, (0, 0, 0, 1))
        dx = None
        for b in ctx.saved_tensors:
            part = dye.index_select(0, b)
            dx = part if dx is None else dx + part
        return (dx, None) + (None,) * len(ctx.saved_tensors)


def to_slots(rows: torch.Tensor, idx: OrderIndex) -> torch.Tensor:
    """rows [B * cap, c] -> the padded patches' slots [tokens, c]; a row's
    gradient is its own slot's plus its duplicate's."""
    return _Gather.apply(rows, idx.gather, idx.unpad, idx.dup)


def from_slots(slots: torch.Tensor, idx: OrderIndex) -> torch.Tensor:
    """slots [tokens, c] -> rows [B * cap, c], each valid row from its own
    slot, invalid rows 0."""
    return _Gather.apply(slots, idx.unpad, idx.own_row)


def patch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T * d**-0.5) v`` per patch and head: q, k, v f32 [P, H, K, d]
    -> [P, H, K, d]."""
    profiling.count("launch.patch_attention")
    if q.device.type == "cuda":
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v)
    return F.scaled_dot_product_attention(q, k, v)
