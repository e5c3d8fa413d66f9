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


class AugmentDraws(NamedTuple):
    """The random parameters of ``b`` augmented frames, on the generator's device."""

    affine: torch.Tensor  # [b, 3, 3] ``(I + 0.1 N) * flip_x @ Rz(theta)``
    r1: torch.Tensor  # [b, 1, 3] uniform, places the frame inside the grid
    r2: torch.Tensor  # [b, 1, 3]

    def rows(self, start: int, stop: int) -> "AugmentDraws":
        return AugmentDraws(*(t[start:stop] for t in self))


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


def sample_augment(generator: torch.Generator, b: int) -> AugmentDraws:
    """Draw the parameters of ``b`` frames in one go.  A caller that splits the
    frames into chunks (multi-view inference) draws once and passes
    ``draws.rows(...)`` to each chunk, so the views do not depend on the
    chunking."""
    dev = generator.device
    affine = _affine(generator, b)
    r1 = torch.rand((b, 1, 3), generator=generator, device=dev)
    r2 = torch.rand((b, 1, 3), generator=generator, device=dev)
    return AugmentDraws(affine, r1, r2)


def augment_and_voxelize(
    generator: Optional[torch.Generator],
    xyz: torch.Tensor,  # [B, P, 3] float32 raw sensor coords (padded)
    sig: torch.Tensor,  # [B, P] float32 intensity
    valid: torch.Tensor,  # [B, P] bool
    cap0: int,
    scale: float = 20.0,
    full_scale: int = 8192,
    augment: bool = True,
    draws: Optional[AugmentDraws] = None,
) -> VoxelizedFrame:
    """``draws`` (from :func:`sample_augment`) takes the place of drawing from
    ``generator`` here."""
    b = xyz.shape[0]
    dev = xyz.device
    if augment:
        if draws is None:
            draws = sample_augment(generator, b)
        xyz_aug = xyz @ draws.affine.to(dev)
    else:
        xyz_aug = xyz

    feats_p = torch.cat([xyz_aug, sig[..., None]], dim=-1).to(torch.float32)

    coords = xyz_aug * scale
    big = 1e30
    cmin = torch.where(valid[..., None], coords, big).amin(dim=1, keepdim=True)
    cmax = torch.where(valid[..., None], coords, -big).amax(dim=1, keepdim=True)
    span = float(full_scale) - (cmax - cmin)
    if augment:
        r1, r2 = draws.r1.to(dev), draws.r2.to(dev)
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
