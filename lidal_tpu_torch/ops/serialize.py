"""Serialization of voxel grids along space-filling curves, for Point
Transformer V3 (Wu et al., CVPR 2024; Pointcept's
``pointcept/models/utils/serialization``).

A voxel's code along one of four curves (:data:`ORDERS`) is a
``3 * depth``-bit integer: ``z`` interleaves the bits of x, y and z (bit i of
x at bit 3i + 2, of y at 3i + 1, of z at 3i); ``hilbert`` is Skilling's
transform (J. Skilling, "Programming the Hilbert curve", AIP Conf. Proc.
707, 2004), the index Pointcept's ``hilbert.encode`` computes; a ``-trans``
order is the same curve over (y, x, z).  Pointcept prefixes the frame
(``frame << 3 * depth | code``); here frames are the leading axis of
``[B, cap]`` tables and each frame sorts on its own, which is the same order.

A coarse level's code is its children's code shifted right by 3 bits: every
voxel of one parent shares it, for both curves, so codes >> 3 group the fine
voxels exactly as ``unique(coords >> 1)`` (``ops/kernel_map.build_down``)
does.  :func:`level_codes` takes it from each parent's first real child
(``DownPlan.child``), a gather.

:func:`sort_orders` gives a level's order per curve (its rows sorted by
code, invalid rows last) and the inverse; :func:`order_perms` the training
draws that shuffle which order each block slot takes, one permutation of the
four orders a level, from the step's seed.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
LAST = torch.iinfo(torch.int64).max  # the code of an invalid row: it sorts after every real one

# Masks of the classic bit spread: 21 bits of a coordinate to every third bit of an int64.
_SPREAD = ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF), (8, 0x100F00F00F00F00F),
           (4, 0x10C30C30C30C30C3), (2, 0x1249249249249249))


def _spread(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x1FFFFF
    for shift, mask in _SPREAD:
        v = (v | (v << shift)) & mask
    return v


def interleave(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Bits i of a, b, c at bits 3i + 2, 3i + 1, 3i (int64, up to 21 bits each)."""
    return (_spread(a) << 2) | (_spread(b) << 1) | _spread(c)


def z_code(coords: torch.Tensor) -> torch.Tensor:
    """coords [..., 3] (non-negative) -> z-order code [...] int64."""
    c = coords.long()
    return interleave(c[..., 0], c[..., 1], c[..., 2])


def hilbert_code(coords: torch.Tensor, depth: int) -> torch.Tensor:
    """coords [..., 3] in [0, 2**depth) -> Hilbert index [...] int64: Skilling's
    axes-to-transpose (undo the excess work, then Gray-encode), then the
    transposed bits interleaved with x most significant."""
    x = [coords[..., i].long() for i in range(3)]
    q = 1 << (depth - 1)
    while q > 1:
        p = q - 1
        for i in range(3):
            on = (x[i] & q) != 0
            if i == 0:
                x[0] = torch.where(on, x[0] ^ p, x[0])
                continue
            t = (x[0] ^ x[i]) & p
            x[0], x[i] = torch.where(on, x[0] ^ p, x[0] ^ t), torch.where(on, x[i], x[i] ^ t)
        q >>= 1
    x[1] = x[1] ^ x[0]
    x[2] = x[2] ^ x[1]
    t = torch.zeros_like(x[2])
    q = 1 << (depth - 1)
    while q > 1:
        t = torch.where((x[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    return interleave(x[0] ^ t, x[1] ^ t, x[2] ^ t)


def curve_code(coords: torch.Tensor, depth: int, order: str) -> torch.Tensor:
    """The code of ``order`` (one of :data:`ORDERS`)."""
    if order.endswith("-trans"):
        coords = coords[..., [1, 0, 2]]
    if order.startswith("z"):
        return z_code(coords)
    if order.startswith("hilbert"):
        return hilbert_code(coords, depth)
    raise ValueError(f"unknown order {order!r}")


def depth_of(max_coord: int) -> int:
    """Bits a side of the cube needs, Pointcept's ``int(max + 1).bit_length()``."""
    return int(max_coord + 1).bit_length()


def level_codes(coords0: torch.Tensor, valid0: torch.Tensor, downs, valids: Sequence[torch.Tensor],
                depth: int) -> List[torch.Tensor]:
    """Codes of every level, ``[levels][orders] [B, cap_l]`` int64 (:data:`LAST`
    on invalid rows): level 0 from ``coords0`` [B, cap0, 3], each coarser
    level its parents' first real child's code >> 3 (``downs[l].child``)."""
    codes = [torch.where(valid0, curve_code(coords0, depth, o), LAST) for o in ORDERS]
    out = [codes]
    for down, valid in zip(downs, valids):
        cap_fine = codes[0].shape[1]
        first = down.child.min(dim=2).values.long().clamp_max(cap_fine - 1)  # [B, cap_coarse]
        codes = [torch.where(valid, c.gather(1, first) >> 3, LAST) for c in codes]
        out.append(codes)
    return out


def sort_orders(codes: torch.Tensor):
    """codes [B, cap] -> (order, inverse) [B, cap] int64: ``order[b, s]`` is the
    row at sorted place s of frame b (valid rows first, by code),
    ``inverse[b, order[b, s]] == s``."""
    order = torch.sort(codes, dim=1, stable=True).indices
    ramp = torch.arange(codes.shape[1], device=codes.device).expand_as(order)
    inverse = torch.empty_like(order).scatter_(1, order, ramp)
    return order, inverse


def order_perms(seed: int, levels: int) -> List[List[int]]:
    """Per level, the order (an index into :data:`ORDERS`) each of the four
    block slots takes: permutations drawn from a CPU generator seeded with
    ``seed``, a level after another (Pointcept shuffles at serialization and
    at each pooling)."""
    g = torch.Generator().manual_seed(int(seed))
    return [torch.randperm(len(ORDERS), generator=g).tolist() for _ in range(levels)]
