"""Coordinate keys for sparse voxel grids (port of ``lidal_tpu/ops/hashing.py``).

A voxel ``(x, y, z)`` packs into an x-major ``(hi, lo)`` int32 pair, exactly as
the JAX package does, so tables and rulebooks compare bit for bit.  Sorting
uses one int64 key ``hi * 2**32 + lo``: with signed ``lo`` in
``[-2**31, 2**31)`` that order is the lexicographic (hi, lo) order.

Supported coordinate range: x, y in ``[-1, 16382]``; z in ``[-1, 2**31 - 3]``.
"""

from __future__ import annotations

import torch

# Sorts after every real key.
SENTINEL_KEY = 2**31 - 1

_SHIFT = 14  # bits reserved for (y + 1) in the hi key


def pack_keys(coords: torch.Tensor, valid: torch.Tensor):
    """Pack integer voxel coords [..., 3] into an x-major (hi, lo) int32 pair.

    Invalid rows get ``(SENTINEL_KEY, SENTINEL_KEY)`` so they sort to the end.
    """
    c = coords.to(torch.int32) + 1  # shift so that -1 (kernel-offset underflow) packs
    hi = (c[..., 0] << _SHIFT) | c[..., 1]
    lo = c[..., 2]
    sent = torch.full_like(hi, SENTINEL_KEY)
    return torch.where(valid, hi, sent), torch.where(valid, lo, sent)


def key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key per (hi, lo) pair, in the same (signed) order."""
    return (hi.to(torch.int64) << 32) + lo.to(torch.int64)


def sort_with_keys(hi: torch.Tensor, lo: torch.Tensor, *vals: torch.Tensor):
    """Stable sort of every operand by (hi, lo) along the last dim.

    Equal keys keep their input order, as ``jax.lax.sort`` does.
    """
    _, perm = torch.sort(key64(hi, lo), dim=-1, stable=True)
    return tuple(v.gather(-1, perm) for v in (hi, lo) + vals)
