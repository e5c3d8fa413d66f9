"""Point Transformer V3's work, counted from the inputs (never from the
program): the attention's operations and bytes per call, and the useful
FLOPs of a train step over a batch of :class:`reference.data.Frame` tables.

Per level l with ``n_l`` valid voxels (the batch's), ``pairs_l`` real
kernel-3 pairs and patches of ``k_l`` tokens (``min(1024, the smallest
frame's count)``, each frame padded to a multiple): a block costs the cpe
conv ``2 x pairs_l x C^2``, its Linears ``2 x n_l x 13 C^2`` (cpe 1, qkv 3,
proj 1, MLP 4 + 4) and the attention ``4 x padded_l x k_l x C`` (q k^T and
the product with v); a pooling ``2 x n_l x C_in x C_out`` over the fine
rows, an unpooling its two Linears over the coarse and the fine rows, the
stem ``2 x real kernel-5 pairs x 4 x 32``, the head ``2 x n_0 x 64 x 19``.
A train step is the forward three times (the input gradient and the weight
gradient; the attention's backward is twice its forward), the stem's twice
(no input gradient)."""

from __future__ import annotations

from typing import List, Sequence

import torch

from lidal_bench.work import nbytes

ENC = ((32, 2), (64, 2), (128, 2), (256, 6), (512, 2))  # channels, blocks
DEC = ((64, 2), (64, 2), (128, 2), (256, 2))
PATCH = 1024
OFFSETS5 = torch.tensor([(a, b, c) for a in range(-2, 3) for b in range(-2, 3) for c in range(-2, 3)])


def attention_work(q, k, v, out):
    """``softmax(q k^T) v`` over ``[P, H, K, d]``: 4 x P x H x K^2 x d operations
    (4 x P x K^2 x C); bytes: q, k, v and the output, each once."""
    p, h, kk, d = q.shape
    return torch.tensor(4.0 * p * h * kk * kk * d), torch.tensor(float(nbytes(q, k, v, out)))


def padded_tokens(sizes: Sequence[int]) -> tuple:
    """(patch size, padded tokens) of frames of ``sizes`` voxels."""
    live = [n for n in sizes if n > 0]
    if not live:
        return 0, 0
    k = min([PATCH] + live)
    return k, sum(-(-n // k) * k for n in live)


def stem_pairs(coords: torch.Tensor) -> int:
    """Real (voxel, tap) pairs of the kernel-5 map of one frame's level-0 voxels."""
    from lidal_bench.reference import data as rdata

    keys = rdata.pack(coords)
    q = rdata.pack(coords[:, None, :] + OFFSETS5.to(coords.device)[None])
    return int((rdata._lookup(keys, q) >= 0).sum())


def step_flops(frames: List, num_classes: int, in_channels: int) -> float:
    """Useful FLOPs of one train step over ``frames`` (one batch)."""
    from lidal_bench.reference import data as rdata

    counts = [rdata.level_counts(fr) for fr in frames]
    n = [sum(c[0][l] for c in counts) for l in range(len(ENC))]
    pairs = [sum(c[1][l] for c in counts) for l in range(len(ENC))]
    fwd = 0.0

    def blocks(l, c, depth):
        k, tokens = padded_tokens([c_[0][l] for c_ in counts])
        return depth * (2.0 * pairs[l] * c * c + 2.0 * n[l] * 13 * c * c + 4.0 * tokens * k * c)

    for l, (c, depth) in enumerate(ENC):
        if l > 0:
            fwd += 2.0 * n[l - 1] * ENC[l - 1][0] * c
        fwd += blocks(l, c, depth)
    for l in reversed(range(len(DEC))):
        c, depth = DEC[l]
        cin = DEC[l + 1][0] if l + 1 < len(DEC) else ENC[-1][0]
        fwd += 2.0 * n[l + 1] * cin * c + 2.0 * n[l] * ENC[l][0] * c
        fwd += blocks(l, c, depth)
    fwd += 2.0 * n[0] * DEC[0][0] * num_classes
    stem = 2.0 * sum(stem_pairs(fr.levels[0].coords) for fr in frames) * in_channels * ENC[0][0]
    return 3.0 * fwd + 2.0 * stem
