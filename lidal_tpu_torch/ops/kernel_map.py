"""Kernel-map ("rulebook") construction (port of ``lidal_tpu/ops/kernel_map.py``).

The whole five-level structure of a batch is built once as a plan of
NamedTuples with the JAX package's field names and ``[B, cap, ...]`` layouts;
every conv of the network is then a gather + GEMM over it.

* **subm** (kernel 3, stride 1): ``nbr3[b, i, k]`` is the row of
  ``coord_i + OFFSETS3[k]`` in the same level, or the sentinel ``cap``;
  PTv3's kernel-5 stem map (:func:`build_subm5_nbr_batched`) is the same
  over ``OFFSETS5``, built only for that model.
* **down** (kernel 2, stride 2): coarse coords are ``unique(coords >> 1)``;
  ``child[b, o, d]`` is the fine row at ``2 * coord_o + OFFSETS2[d]``.
* **up**: ``parent[b, f]`` and ``pdelta[b, f]``, the same pairing seen from
  the fine side.
"""

from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from lidal_tpu_torch.ops.hashing import SENTINEL_KEY, pack_keys
from lidal_tpu_torch.ops.merge_lookup import lookup_sorted_grouped
from lidal_tpu_torch.ops.voxelize import unique_voxels

# Kernel-3 offsets in x-major product order; OFFSETS3[K3 - 1 - k] == -OFFSETS3[k].
OFFSETS3 = tuple(itertools.product((-1, 0, 1), repeat=3))
K3 = len(OFFSETS3)  # 27
CENTER3 = 13  # index of (0, 0, 0)

# Kernel-2 offsets, d = (dx<<2)|(dy<<1)|dz (torchsparse get_kernel_offsets(2) taps).
OFFSETS2 = tuple(itertools.product((0, 1), repeat=3))
K2 = len(OFFSETS2)  # 8

# Kernel-5 offsets (PTv3's stem), x-major; OFFSETS5[K5 - 1 - k] == -OFFSETS5[k].
OFFSETS5 = tuple(itertools.product((-2, -1, 0, 1, 2), repeat=3))
K5 = len(OFFSETS5)  # 125
CENTER5 = 62

_OFFS26 = [o for o in OFFSETS3 if o != (0, 0, 0)]
_OFFS124 = [o for o in OFFSETS5 if o != (0, 0, 0)]


def _key_deltas(offsets):
    """Each offset's delta of the packed (hi, lo) key (``hashing.pack_keys``).
    A y of -1 or -2 borrows from x in ``hi`` and names y = 16382 or 16381,
    which no voxel of a grid under ``full_scale`` holds: such a query misses."""
    return tuple((dx << 14) + dy for dx, dy, _ in offsets), tuple(dz for _, _, dz in offsets)


_D_HI, _D_LO = _key_deltas(_OFFS26)
_D5_HI, _D5_LO = _key_deltas(_OFFS124)

_CONSTANTS: Dict = {}  # (values, dtype, device) -> tensor


def device_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made at the first
    call for a device and kept.  A host-to-device copy waits for the stream,
    and none may run while a CUDA graph captures the plan
    (``runtime/prob_inference``), so the plan takes its constants from here.
    Callers only read them."""
    key = (values, dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


class LevelPlan(NamedTuple):
    """One resolution level: sorted unique voxel table + its kernel-3 rulebook."""

    coords: torch.Tensor  # [B, cap, 3] int32, unit coords at this level
    valid: torch.Tensor  # [B, cap] bool
    nbr3: torch.Tensor  # [B, cap, 27] int32 into this level (sentinel = cap)
    num_valid: torch.Tensor  # [B] int32
    overflow: torch.Tensor  # [B] int32: unique voxels dropped past the capacity


class DownPlan(NamedTuple):
    """Pairing between a fine level l and coarse level l+1."""

    child: torch.Tensor  # [B, cap_coarse, 8] int32 into fine (sentinel = cap_fine)
    parent: torch.Tensor  # [B, cap_fine] int32 into coarse (sentinel = cap_coarse)
    pdelta: torch.Tensor  # [B, cap_fine] int32 in [0, 8)


class UNetPlan(NamedTuple):
    levels: Tuple[LevelPlan, ...]
    downs: Tuple[DownPlan, ...]


def rulebook_streams(coords: torch.Tensor, valid: torch.Tensor, deltas=(_D_HI, _D_LO)):
    """The lookups of one level's rulebook: tables [B, cap] and the B x 26
    offset query streams [B * 26, cap] (frame-major; ``deltas`` gives
    other offsets' key deltas, B x len(offsets) streams).

    A kernel offset adds a constant to the packed key, computed in int32 as
    the JAX package does (``kernel_map.py:138-141``), so each stream stays
    sorted and misses agree bit for bit."""
    b, cap, _ = coords.shape
    dev = coords.device
    key_hi, key_lo = pack_keys(coords, valid)  # [B, cap]
    d_hi = device_constant(deltas[0], torch.int32, dev)
    d_lo = device_constant(deltas[1], torch.int32, dev)
    q_hi = torch.where(valid[:, None, :], key_hi[:, None, :] + d_hi[None, :, None], SENTINEL_KEY)
    q_lo = torch.where(valid[:, None, :], key_lo[:, None, :] + d_lo[None, :, None], SENTINEL_KEY)
    s = len(deltas[0])
    return key_hi, key_lo, q_hi.reshape(b * s, cap), q_lo.reshape(b * s, cap)


def build_subm_nbr_batched(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Kernel-3 stride-1 rulebook: coords [B, cap, 3] -> nbr [B, cap, 27].

    All B x 26 offset streams go to one lookup launch."""
    b, cap, _ = coords.shape
    nbr26 = lookup_sorted_grouped(*rulebook_streams(coords, valid)).reshape(b, len(_OFFS26), cap)
    own = torch.arange(cap, dtype=torch.int32, device=coords.device)
    center = torch.where(valid, own[None, :], cap).to(torch.int32)
    nbr = torch.cat([nbr26[:, :CENTER3], center[:, None, :], nbr26[:, CENTER3:]], dim=1)
    return nbr.transpose(1, 2).contiguous()  # [B, cap, 27]


def build_subm5_nbr_batched(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Kernel-5 stride-1 rulebook (PTv3's stem): coords [B, cap, 3] -> nbr
    [B, cap, 125], all B x 124 offset streams in one lookup launch."""
    b, cap, _ = coords.shape
    n = len(_OFFS124)
    nbr = lookup_sorted_grouped(*rulebook_streams(coords, valid, (_D5_HI, _D5_LO))).reshape(b, n, cap)
    own = torch.arange(cap, dtype=torch.int32, device=coords.device)
    center = torch.where(valid, own[None, :], cap).to(torch.int32)
    nbr = torch.cat([nbr[:, :CENTER5], center[:, None, :], nbr[:, CENTER5:]], dim=1)
    return nbr.transpose(1, 2).contiguous()  # [B, cap, 125]


def build_down(coords_fine: torch.Tensor, valid_fine: torch.Tensor, cap_coarse: int):
    """Build the coarse level (``unique(coords >> 1)``) and the down/up pairing.

    coords_fine [B, cap_fine, 3], valid_fine [B, cap_fine]."""
    b, cap_fine, _ = coords_fine.shape
    dev = coords_fine.device
    uvc = unique_voxels(coords_fine >> 1, valid_fine, cap_coarse)
    parent = uvc.inverse  # [B, cap_fine], sentinel cap_coarse
    low = coords_fine & 1
    pdelta = (low[..., 0] << 2) | (low[..., 1] << 1) | low[..., 2]
    pdelta = torch.where(valid_fine, pdelta, 0).to(torch.int32)
    # child[b, parent[f], pdelta[f]] = f; rows of invalid fine voxels and of
    # parents past the capacity land in a dropped extra row cap_coarse
    fine_ids = torch.arange(cap_fine, dtype=torch.int32, device=dev).expand(b, cap_fine)
    tgt_row = torch.where(valid_fine, parent, cap_coarse).long()
    frame = torch.arange(b, device=dev)[:, None]
    flat = (frame * (cap_coarse + 1) + tgt_row) * K2 + pdelta.long()
    child = torch.full((b * (cap_coarse + 1) * K2,), cap_fine, dtype=torch.int32, device=dev)
    child[flat.reshape(-1)] = torch.where(valid_fine, fine_ids, cap_fine).reshape(-1)
    child = child.reshape(b, cap_coarse + 1, K2)[:, :cap_coarse].contiguous()
    return uvc, DownPlan(child=child, parent=parent, pdelta=pdelta)


def build_unet_plan(coords0: torch.Tensor, valid0: torch.Tensor, caps: Sequence[int]) -> UNetPlan:
    """Multi-level plan of a batch.

    Args:
      coords0: [B, cap0, 3] sorted unique level-0 voxels (the output of
        :func:`unique_voxels`); valid0: [B, cap0].
      caps: per-level capacities, ``caps[0] == cap0``.
    """
    levels = []
    downs = []
    cur_coords, cur_valid = coords0, valid0
    # level 0 is deduplicated by the caller, which accounts its overflow
    cur_overflow = torch.zeros(coords0.shape[0], dtype=torch.int32, device=coords0.device)
    for l in range(len(caps)):
        levels.append(
            LevelPlan(
                coords=cur_coords,
                valid=cur_valid,
                nbr3=build_subm_nbr_batched(cur_coords, cur_valid),
                num_valid=cur_valid.sum(dim=1).to(torch.int32),
                overflow=cur_overflow,
            )
        )
        if l + 1 < len(caps):
            uvc, down = build_down(cur_coords, cur_valid, caps[l + 1])
            downs.append(down)
            cur_coords, cur_valid = uvc.coords, uvc.valid
            cur_overflow = (uvc.num_unique - uvc.valid.sum(dim=1)).to(torch.int32)
    return UNetPlan(levels=tuple(levels), downs=tuple(downs))

