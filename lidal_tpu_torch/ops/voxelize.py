"""Voxel dedup and voxel->point projection (port of ``lidal_tpu/ops/voxelize.py``).

:func:`unique_voxels` is ``np.unique(coords, axis=0, return_index=True,
return_inverse=True)`` at a fixed output capacity, bit-equal to the JAX
version on every field.  It works on one frame ``[n, 3]`` or a batch
``[B, n, 3]`` (each frame on its own), where the JAX package vmaps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidal_tpu_torch.ops.hashing import SENTINEL_KEY, pack_keys, sort_with_keys


class UniqueVoxels(NamedTuple):
    """Result of :func:`unique_voxels` with output capacity ``cap_out``.

    Attributes (leading batch dims omitted):
      coords: [cap_out, 3] int32 unique voxel coords, sorted x-major; rows past
        ``num_unique`` are zeros.
      key_hi/key_lo: [cap_out] packed keys of ``coords`` (sentinel past the end).
      valid: [cap_out] bool.
      first_src: [cap_out] int32 input index of each voxel's first point.
      inverse: [n] int32 point -> voxel; invalid or overflowed points map to
        ``cap_out``.
      counts: [cap_out] int32 valid points per voxel.
      num_unique: [] int32 true unique count (may exceed ``cap_out``).
    """

    coords: torch.Tensor
    key_hi: torch.Tensor
    key_lo: torch.Tensor
    valid: torch.Tensor
    first_src: torch.Tensor
    inverse: torch.Tensor
    counts: torch.Tensor
    num_unique: torch.Tensor


def unique_voxels(coords: torch.Tensor, valid: torch.Tensor, cap_out: int) -> UniqueVoxels:
    """Deduplicate integer voxel coords [..., n, 3] under a validity mask [..., n]."""
    lead = coords.shape[:-2]
    n = coords.shape[-2]
    coords = coords.reshape(-1, n, 3).to(torch.int32)
    valid = valid.reshape(-1, n)
    b = coords.shape[0]
    dev = coords.device

    hi, lo = pack_keys(coords, valid)
    idx = torch.arange(n, dtype=torch.int64, device=dev).expand(b, n)
    s_hi, s_lo, s_idx = sort_with_keys(hi, lo, idx)
    s_valid = s_hi != SENTINEL_KEY

    first = s_valid.clone()
    first[:, 1:] &= (s_hi[:, 1:] != s_hi[:, :-1]) | (s_lo[:, 1:] != s_lo[:, :-1])
    group = torch.cumsum(first, dim=1) - 1  # sorted position -> voxel id
    num_unique = first.sum(dim=1).to(torch.int32)
    n_valid = s_valid.sum(dim=1)

    # starts[g] = sorted position where voxel g begins, for g <= cap_out;
    # voxels past num_unique start at n_valid so their counts vanish.  Column
    # cap_out + 1 takes the writes of every other position and is dropped.
    starts = n_valid[:, None].repeat(1, cap_out + 2)
    tgt = torch.where(first & (group <= cap_out), group, cap_out + 1)
    starts.scatter_(1, tgt, idx.contiguous())
    starts = starts[:, : cap_out + 1]
    counts = (starts[:, 1:] - starts[:, :cap_out]).to(torch.int32)

    slot = torch.arange(cap_out, device=dev)
    out_valid = slot[None, :] < torch.clamp_max(num_unique, cap_out)[:, None]
    # s_idx at a group's start is the lowest input index of that voxel (stable sort)
    src = s_idx.gather(1, torch.clamp_max(starts[:, :cap_out], max(n - 1, 0)))
    first_src = torch.where(out_valid, src, 0)
    out_coords = coords.gather(1, first_src[..., None].expand(b, cap_out, 3))
    out_coords = torch.where(out_valid[..., None], out_coords, 0).to(torch.int32)
    key_hi, key_lo = pack_keys(out_coords, out_valid)

    # point -> voxel id in input order; s_idx is a permutation, so one scatter inverts it
    pt_group = torch.where(s_valid & (group < cap_out), group, cap_out).to(torch.int32)
    inverse = torch.empty((b, n), dtype=torch.int32, device=dev).scatter_(1, s_idx, pt_group)

    out = UniqueVoxels(
        out_coords, key_hi, key_lo, out_valid, first_src.to(torch.int32), inverse, counts, num_unique
    )
    return UniqueVoxels(*(t.reshape(lead + t.shape[1:]) for t in out))


def voxelize_mean(point_feats: torch.Tensor, inverse: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Average point features into their voxels (torchsparse ``F.spvoxelize``
    over ``idx_query`` / ``counts``, reference ``network/utils.py:20-25``),
    one frame.

    Args:
      point_feats: [n, c] float features; rows of invalid points may be
        anything, their ``inverse`` must be the sentinel ``cap_out``.
      inverse: [n] int32 point -> voxel (sentinel = ``counts.shape[0]``).
      counts: [cap_out] int32 valid points per voxel.

    Returns [cap_out, c] mean features (zero where the voxel is empty).  The
    sum is an ``index_add_``; on a card its order, and so the last bits of
    the result, can change from run to run.
    """
    cap_out = counts.shape[0]
    sums = point_feats.new_zeros((cap_out + 1, point_feats.shape[-1]))
    sums.index_add_(0, inverse.long(), point_feats)
    return sums[:cap_out] / counts.clamp_min(1).to(point_feats.dtype)[:, None]


def devoxelize_nearest(voxel_feats_ext: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """Project voxel features [..., cap_out + 1, C] to points [..., P, C] by the
    voxelization inverse; the extra zero row at ``cap_out`` is the sentinel slot."""
    return torch.take_along_dim(voxel_feats_ext, inverse[..., None].long(), dim=-2)


def append_zero_row(feats: torch.Tensor) -> torch.Tensor:
    """Append a zero sentinel row (dim -2) so sentinel indices gather zeros."""
    return torch.cat([feats, feats.new_zeros(feats.shape[:-2] + (1,) + feats.shape[-1:])], dim=-2)
