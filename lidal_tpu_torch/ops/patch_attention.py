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
v`` over ``[patches, heads, k, d]`` in f32, with its own backward
(:func:`patch_attention_backward`, from the output and the rows' log-sum-exp).
A CUDA tensor runs the hand-written kernels of ``csrc/patch_attention.cu``
(split-TF32 products, f32 softmax, the ``k x k`` scores never stored, sums in
an order the shape fixes), compiled for ``d = 16`` only; a CPU tensor runs the
plain versions, :func:`patch_attention_plain` and
:func:`patch_attention_backward_plain`: explicit products and softmax over
blocks of patches, the backward written out as the kernels compute it.  Each
call of :func:`patch_attention` counts ``launch.patch_attention``, on either
device; each kernel launch on a card counts ``launch.attn_fwd`` (one a
forward) or ``launch.attn_bwd`` (two a backward: dq, then dk and dv).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from lidal_tpu_torch import kernels_build
from lidal_tpu_torch.utils import profiling

HEAD_DIM = 16  # the head dimension the kernels are compiled for (C / heads in every PTv3 stage)
PLAIN_SCORES = 1 << 24  # scores a block of the plain versions holds at once


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


def check_kernel_operands(q: torch.Tensor, *rest: torch.Tensor) -> None:
    """What the kernels take: ``q`` and each of ``rest`` (k, v, o, dO) contiguous
    f32 ``[P, H, K, 16]`` of one shape on q's device, 16-byte aligned.
    Raises ``ValueError`` otherwise: there is no fallback."""
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the attention kernels take q, k, v [P, H, K, {HEAD_DIM}], got {tuple(q.shape)}")
    for x in (q,) + rest:
        if x.shape != q.shape or x.dtype != torch.float32 or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"contiguous f32 {tuple(q.shape)} on {q.device} expected, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if x.data_ptr() % 16:
            raise ValueError("the attention kernels read 16-byte slices: operands must be 16-byte aligned")


def _blocks(q: torch.Tensor):
    """Slices of the patch dimension holding at most :data:`PLAIN_SCORES` scores."""
    p, h, kk, _ = q.shape
    step = max(1, PLAIN_SCORES // max(1, h * kk * kk))
    return [slice(s, s + step) for s in range(0, p, step)]


def patch_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward: ``(o, lse)``, ``o = softmax(s) v`` and
    ``lse = logsumexp(s)`` over ``s = q k^T * d**-0.5``, per block of patches."""
    scale = q.shape[-1] ** -0.5
    o, lse = torch.empty_like(q), q.new_empty(q.shape[:-1])
    for b in _blocks(q):
        s = (q[b] @ k[b].transpose(-2, -1)) * scale
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        den = e.sum(-1, keepdim=True)
        o[b] = (e @ v[b]) / den
        lse[b] = (m + torch.log(den)).squeeze(-1)
    return o, lse


def patch_attention_backward_plain(q, k, v, o, lse, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, as the kernels compute it: ``D =
    rowsum(dO o)``, ``P = exp(s - lse)``, ``dS = P (dO v^T - D)``, then ``dq =
    dS k * scale``, ``dk = dS^T q * scale``, ``dv = P^T dO``."""
    scale = q.shape[-1] ** -0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = (do * o).sum(-1, keepdim=True)
    for b in _blocks(q):
        p = torch.exp((q[b] @ k[b].transpose(-2, -1)) * scale - lse[b][..., None])
        ds = p * (do[b] @ v[b].transpose(-2, -1) - dvec[b])
        dq[b] = (ds @ k[b]) * scale
        dk[b] = (ds.transpose(-2, -1) @ q[b]) * scale
        dv[b] = p.transpose(-2, -1) @ do[b]
    return dq, dk, dv


def patch_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of q, k, v f32 ``[P, H, K, d]``: the output and each row's
    log-sum-exp of its scaled scores ``[P, H, K]``."""
    if q.device.type == "cpu":
        return patch_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"patch attention runs on CPU or CUDA tensors, got {q.device}")
    check_kernel_operands(q, k, v)
    p, h, kk, d = q.shape
    o, lse = torch.empty_like(q), q.new_empty((p, h, kk))
    fn = kernels_build.function("patch_attention", "lidal_attn_fwd",
                                [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), p * h, kk, d**-0.5,
                 torch.cuda.current_stream().cuda_stream)
    kernels_build.check(err, "patch attention forward")
    if q.numel():  # an empty call launches nothing
        profiling.count("launch.attn_fwd")
    return o, lse


def patch_attention_backward(q, k, v, o, lse, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of the attention from its inputs, its output ``o``, the
    rows' log-sum-exp ``lse`` and the output's gradient ``do``.  On a card two
    launches (dq, then dk and dv), bit-equal on reruns: no float atomics."""
    if q.device.type == "cpu":
        return patch_attention_backward_plain(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"patch attention runs on CPU or CUDA tensors, got {q.device}")
    check_kernel_operands(q, k, v, o, do)
    p, h, kk, d = q.shape
    if lse.shape != (p, h, kk) or lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 {(p, h, kk)} on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dvec = torch.empty_like(lse)
    fn = kernels_build.function("patch_attention", "lidal_attn_bwd",
                                [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dvec.data_ptr(), p * h, kk, d**-0.5,
                 torch.cuda.current_stream().cuda_stream)
    kernels_build.check(err, "patch attention backward")
    if q.numel():
        profiling.count("launch.attn_bwd", 2)
    return dq, dk, dv


class _PatchAttention(torch.autograd.Function):
    """The forward keeps ``o`` and ``lse``; the backward calls
    :func:`patch_attention_backward` through the module, where a wrapper may
    replace it."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = patch_attention_forward(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return patch_attention_backward(*ctx.saved_tensors, do.contiguous())


def patch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T * d**-0.5) v`` per patch and head: q, k, v f32 [P, H, K, d]
    -> [P, H, K, d], differentiable in all three."""
    profiling.count("launch.patch_attention")
    return _PatchAttention.apply(q, k, v)
