"""Point<->voxel transfer ops of the SPVCNN point branch (port of
``lidal_tpu/ops/devoxelize.py``).

Counterparts of torchsparse ``voxel_to_point`` (8-corner trilinear devoxelize,
reference ``network/utils.py:66-102``) and ``point_to_voxel`` (average of the
points of a voxel, ``network/utils.py:38-61``).

With the reference data pipeline SPVCNN's "points" are exactly the level-0
voxels (``initial_voxelize`` re-hashes integer coords at the same resolution),
so the point set is the level-0 voxel table, point coords are the integer
level-0 coords, and stride-1 transfers are identities.  All cross-stride maps
are built once per batch into a :class:`PointPlan`, batched: every field
carries the leading frame axis ``[B, ...]`` of the :class:`UNetPlan`.

Both transfers run on one kernel, ``ops/cuda_gather8.gather8``: the trilinear
devoxelize is the weighted 8-tap gather itself, and the average is a chain of
8-tap child sums down the voxel tree (weights 1) divided by the precomputed
ancestor counts.  The wrapper is called through its module, so a caller can
swap in the plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from lidal_tpu_torch.ops import cuda_gather8
from lidal_tpu_torch.ops.conv import _flatten_idx, _flatten_nbr
from lidal_tpu_torch.ops.kernel_map import OFFSETS2, DownPlan, UNetPlan


class TriMap(NamedTuple):
    """Trilinear devoxelize map from level-0 "points" to one coarser level."""

    idx8: torch.Tensor  # [B, cap0, 8] int32 into the target level (sentinel = cap_l)
    w8: torch.Tensor  # [B, cap0, 8] float32 trilinear weights (0 where the corner is missing)


class AvgMap(NamedTuple):
    """Point->voxel average map from level-0 "points" to one coarser level."""

    anc: torch.Tensor  # [B, cap0] int32 ancestor voxel at the target level (sentinel = cap_l)
    counts: torch.Tensor  # [B, cap_l] int32 number of points per target voxel


class PointPlan(NamedTuple):
    """Cross-stride transfer maps used by SPVCNN (levels 2 and 4)."""

    tri2: TriMap
    tri4: TriMap
    avg2: AvgMap
    avg4: AvgMap


# Corner offsets {0,1}^3 as tap indices into the x-major OFFSETS3 ({-1,0,1}^3)
# enumeration: tap(d) = (dx+1)*9 + (dy+1)*3 + (dz+1).
_TAP8 = tuple((dx + 1) * 9 + (dy + 1) * 3 + (dz + 1) for dx, dy, dz in OFFSETS2)


def _build_tri(coords0, valid0, anc, level_nbr3, lshift: int) -> TriMap:
    """Corners floor(c / 2^l) + delta, weights prod(delta ? u : 1 - u), u = frac(c / 2^l).

    The corner at offset d of point p is a kernel-3 neighbour of p's level-l
    ancestor voxel (the base coords are the ancestor's), so ``idx8`` composes
    the ancestor chain with the level's rulebook, ``nbr3[anc[p], tap(d)]``,
    and needs no lookup of its own."""
    s = 1 << lshift
    dev = coords0.device
    b, cap_l, _ = level_nbr3.shape
    u = (coords0 & (s - 1)).to(torch.float32) / float(s)  # [B, cap0, 3]
    # a sentinel ancestor (== cap_l) gathers the appended all-sentinel row
    corners = level_nbr3[:, :, list(_TAP8)]  # [B, cap_l, 8]
    corners = torch.cat([corners, corners.new_full((b, 1, len(_TAP8)), cap_l)], dim=1)
    idx8 = corners.gather(1, anc.long()[..., None].expand(-1, -1, len(_TAP8)))  # [B, cap0, 8]
    offs = torch.tensor(OFFSETS2, dtype=torch.bool, device=dev)  # [8, 3], d = (dx<<2)|(dy<<1)|dz
    w = torch.where(offs[None, None], u[:, :, None, :], 1.0 - u[:, :, None, :]).prod(dim=-1)  # [B, cap0, 8]
    w = torch.where((idx8 < cap_l) & valid0[..., None], w, 0.0)
    return TriMap(idx8=idx8.to(torch.int32), w8=w.to(torch.float32))


def build_point_plan(plan: UNetPlan) -> PointPlan:
    """The SPVCNN transfer maps of a batch from its UNet plan."""
    lv0 = plan.levels[0]
    coords0, valid0 = lv0.coords, lv0.valid
    b, cap0 = valid0.shape
    dev = coords0.device

    # Ancestor chains: compose the parent maps; a sentinel stays a sentinel.
    own = torch.arange(cap0, dtype=torch.int32, device=dev)
    cur = torch.where(valid0, own[None, :], cap0).to(torch.int32)
    ancs = {}
    for l, down in enumerate(plan.downs):
        cap_next = plan.levels[l + 1].coords.shape[1]
        parent_ext = torch.cat([down.parent, down.parent.new_full((b, 1), cap_next)], dim=1)
        cur = parent_ext.gather(1, cur.clamp_max(down.parent.shape[1]).long())
        ancs[l + 1] = cur

    def avg_map(l: int) -> AvgMap:
        cap_l = plan.levels[l].coords.shape[1]
        # integers: the scatter-add is exact in any order; column cap_l takes the sentinels
        counts = torch.zeros((b, cap_l + 1), dtype=torch.int32, device=dev)
        counts.scatter_add_(1, ancs[l].long(), valid0.to(torch.int32))
        return AvgMap(anc=ancs[l], counts=counts[:, :cap_l].contiguous())

    tri2 = _build_tri(coords0, valid0, ancs[2], plan.levels[2].nbr3, 2)
    tri4 = _build_tri(coords0, valid0, ancs[4], plan.levels[4].nbr3, 4)
    return PointPlan(tri2=tri2, tri4=tri4, avg2=avg_map(2), avg4=avg_map(4))


def build_point_plan_frame(plan_levels, plan_downs) -> PointPlan:
    """The transfer maps of ONE frame from its unbatched levels and downs."""
    batched = UNetPlan(
        levels=tuple(type(lv)(*(t[None] for t in lv)) for lv in plan_levels),
        downs=tuple(type(dn)(*(t[None] for t in dn)) for dn in plan_downs),
    )
    pp = build_point_plan(batched)
    return PointPlan(*(type(m)(*(t[0] for t in m)) for m in pp))


def devoxelize_trilinear_batched(voxel_feats: torch.Tensor, tri: TriMap) -> torch.Tensor:
    """spdevoxelize: out[b, p] = sum_d w8[b, p, d] * voxel_feats[b, idx8[b, p, d]]
    (a missing corner adds 0).  [B, cap_l, c] -> [B, cap0, c], one ``gather8``
    launch for the batch."""
    b, cap_l, c = voxel_feats.shape
    m = tri.idx8.shape[1]
    out = cuda_gather8.gather8(
        voxel_feats.reshape(b * cap_l, c), _flatten_nbr(tri.idx8, cap_l), tri.w8.reshape(b * m, 8)
    )
    return out.reshape(b, m, c)


def devoxelize_trilinear(voxel_feats: torch.Tensor, tri: TriMap) -> torch.Tensor:
    """One frame: voxel_feats [cap_l, c], unbatched ``tri`` -> [cap0, c]."""
    return devoxelize_trilinear_batched(voxel_feats[None], TriMap(tri.idx8[None], tri.w8[None]))[0]


class _ChildSum(torch.autograd.Function):
    """One level down the voxel tree: out[b, o] = sum_d x[b, child[b, o, d]].

    Every fine row has exactly one parent, so the backward is the plain row
    gather dx[b, f] = dy[b, parent[b, f]] (zero where the parent is the
    sentinel): no scatter in either direction."""

    @staticmethod
    def forward(ctx, x, child, parent):
        b, cap_f, c = x.shape
        ctx.save_for_backward(parent)
        nbr = _flatten_nbr(child, cap_f)
        ones = torch.ones(nbr.shape, dtype=torch.float32, device=x.device)
        out = cuda_gather8.gather8_forward(x.reshape(b * cap_f, c).contiguous(), nbr, ones)
        return out.reshape(b, child.shape[1], c)

    @staticmethod
    def backward(ctx, dy):
        (parent,) = ctx.saved_tensors
        b, cap_c, c = dy.shape
        idx = _flatten_idx(parent, cap_c).long()
        real = idx < b * cap_c
        dx = dy.reshape(b * cap_c, c).index_select(0, idx.clamp_max(max(b * cap_c - 1, 0)))
        dx.masked_fill_(~real[:, None], 0.0)  # dx is new memory
        return dx.reshape(b, parent.shape[1], c), None, None


def _child_sum(x: torch.Tensor, child: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    return _ChildSum.apply(x, child, parent)


def point_to_voxel_avg_batched(
    point_feats: torch.Tensor, downs: Sequence[DownPlan], avg: AvgMap, levels: int
) -> torch.Tensor:
    """spvoxelize average [B, cap0, c] -> [B, cap_l, c] (invalid point rows
    must be zero): ``levels`` chained 8-tap child sums down the tree, then
    the divide by the precomputed ancestor counts (an empty voxel divides by
    1).  Equal to :func:`point_to_voxel_avg` because a voxel dropped at a
    level cap drops its whole subtree from ``child`` and from ``anc`` alike."""
    x = point_feats
    for l in range(levels):
        x = _child_sum(x, downs[l].child, downs[l].parent)
    return x / avg.counts.clamp_min(1).to(x.dtype)[..., None]


def point_to_voxel_avg(point_feats: torch.Tensor, avg: AvgMap) -> torch.Tensor:
    """The scatter form of the average, one frame: point_feats [cap0, c]
    (invalid rows must be zero), unbatched ``avg`` -> [cap_l, c].  The oracle
    of the child-sum chain in the tests; ``index_add_`` on floats is not
    deterministic on a card, so no entry point calls it."""
    cap_l = avg.counts.shape[0]
    sums = point_feats.new_zeros((cap_l + 1, point_feats.shape[-1]))
    sums.index_add_(0, avg.anc.long(), point_feats)
    return sums[:cap_l] / avg.counts.clamp_min(1).to(point_feats.dtype)[:, None]
