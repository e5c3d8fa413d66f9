"""Augmentation + voxelization (port of ``lidal_tpu/data/augment.py``).

The reference per-frame pipeline (``dataset/sk_dataset.py:143-169``): random
affine ``I + 0.1 * N(0,1)^{3x3}`` with a random x-flip and z-rotation, point
features ``[augmented xyz, intensity]``, scale by 20, random translation into
the ``[0, 8192)^3`` grid, truncation to voxel coords and keep-first dedup.

Frames run as a batch ``[B, P]``; the random draws come from an explicit
``torch.Generator`` (one set per frame), so they differ from ``jax.random``
streams but have the same distribution.  ``augment=False`` is deterministic
and bit-equal to the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from lidal_tpu_torch.ops.voxelize import UniqueVoxels, unique_voxels


class VoxelizedFrame(NamedTuple):
    uv: UniqueVoxels  # voxel table (coords/valid/first_src/inverse/counts)
    feats: torch.Tensor  # [B, cap0, 4] voxel features (first point's [xyz_aug, sig])
    point_valid: torch.Tensor  # [B, P] bool: input mask & in-grid & not overflowed


def _affine(generator: torch.Generator, b: int) -> torch.Tensor:
    """[b, 3, 3] per-frame ``(I + 0.1 N) * flip_x @ Rz(theta)``."""
    dev = generator.device
    trans = torch.eye(3, device=dev) + torch.randn((b, 3, 3), generator=generator, device=dev) * 0.1
    flip = torch.randint(0, 2, (b,), generator=generator, device=dev) * 2 - 1
    trans[:, 0, 0] *= flip.to(trans.dtype)
    theta = torch.rand((b,), generator=generator, device=dev) * 2.0 * math.pi
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack(
        [torch.stack([c, s, zero], -1), torch.stack([-s, c, zero], -1), torch.stack([zero, zero, one], -1)],
        dim=1,
    )
    return trans @ rot


def augment_and_voxelize(
    generator: Optional[torch.Generator],
    xyz: torch.Tensor,  # [B, P, 3] float32 raw sensor coords (padded)
    sig: torch.Tensor,  # [B, P] float32 intensity
    valid: torch.Tensor,  # [B, P] bool
    cap0: int,
    scale: float = 20.0,
    full_scale: int = 8192,
    augment: bool = True,
) -> VoxelizedFrame:
    b = xyz.shape[0]
    dev = xyz.device
    if augment:
        xyz_aug = xyz @ _affine(generator, b).to(dev)
    else:
        xyz_aug = xyz

    feats_p = torch.cat([xyz_aug, sig[..., None]], dim=-1).to(torch.float32)

    coords = xyz_aug * scale
    big = 1e30
    cmin = torch.where(valid[..., None], coords, big).amin(dim=1, keepdim=True)
    cmax = torch.where(valid[..., None], coords, -big).amax(dim=1, keepdim=True)
    span = float(full_scale) - (cmax - cmin)
    if augment:
        r1 = torch.rand((b, 1, 3), generator=generator, device=generator.device).to(dev)
        r2 = torch.rand((b, 1, 3), generator=generator, device=generator.device).to(dev)
    else:
        r1 = r2 = torch.full((1, 1, 3), 0.5, device=dev)
    offset = -cmin + torch.clamp_min(span - 0.001, 0.0) * r1 + torch.clamp_max(span + 0.001, 0.0) * r2
    coords = coords + offset

    # The reference asserts all points land in-grid (sk_dataset.py:160-161); out-of-grid
    # points are masked instead (only possible when a frame spans > 409 m).
    in_grid = (coords.amin(dim=-1) >= 0) & (coords.amax(dim=-1) < full_scale)
    pvalid = valid & in_grid

    coords_v = torch.where(pvalid[..., None], coords, 0.0).to(torch.int32)  # trunc == floor here
    uv = unique_voxels(coords_v, pvalid, cap0)
    feats_v = feats_p.gather(1, uv.first_src.long()[..., None].expand(-1, -1, 4))
    feats_v = torch.where(uv.valid[..., None], feats_v, 0.0)
    point_valid = pvalid & (uv.inverse < cap0)
    return VoxelizedFrame(uv=uv, feats=feats_v, point_valid=point_valid)
