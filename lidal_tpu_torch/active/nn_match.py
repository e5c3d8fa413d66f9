"""Nearest-neighbour matching between pose-registered LiDAR frames on the
device (port of ``lidal_tpu/active/nn_match.py``).

Replaces the sklearn KD-tree hot loop of LiDAL scoring (reference
``score/sv_level/LiDAL.py:59-72``: ``tree.query(query_points, k=1)`` against 24
neighbor frames, match if distance <= 0.1 m).

Design: a uniform hash grid with cell size == the match threshold.  Any
neighbor point within 0.1 m of a query lies in the query's 3x3x3 cell
neighborhood; with both sides cell-sorted, all 27 neighborhood cells of a
whole query TILE live in one contiguous key range of the table, located by two
lower bounds per tile (the (-1,-1,-1) probe key of the tile's first query and
the (+1,+1,+2) key of its last; lower bounds are monotone in the packed key).
The kernel (``ops/cuda_nnband.py``) then scans that band with a full pairwise
distance: no candidate caps, no overflow, matches exact by construction.

Cell packing: ``hi = cx`` (full int32 range) and
``lo = (cy + 2^15) << 12 | (cz + 2^11)``, carry-free under +-1 shifts, so cell
order == lexicographic (cx, cy, cz) order.  Supported range at 0.1 m cells:
|y| < ~3276 m, |z| < ~204 m; x unbounded.

Every integer field (keys, ``src_idx``, ``valid``, ``s_qidx``, ``s_ok``, corner
keys, band bounds) is bit-equal to the JAX package; ``planar`` and ``q_t`` are
the same floats, held as ``[3, cap]`` and ``[3, p]`` (the JAX package's
``[3, cap/128, 128]`` and the zero fourth query row are TPU tilings).

Tie-breaking: among equidistant nearest candidates the LOWEST cell-sorted
table row wins.  Match contract: results are exact for matches (distance <=
cell); for unmatched queries ``dist`` may reflect any band candidate (or inf).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from lidal_tpu_torch.ops import cuda_nnband
from lidal_tpu_torch.ops.cuda_nnband import BIG_COORD, TILE, TN
from lidal_tpu_torch.ops.hashing import SENTINEL_KEY, key64, sort_with_keys

_Y_OFF = 1 << 15
_Z_OFF = 1 << 11
_Z_BITS = 12


def pack_cells(cells: torch.Tensor, valid: torch.Tensor):
    """[..., 3] int32 cell coords -> (hi, lo) keys; invalid -> sentinels."""
    hi = cells[..., 0]
    lo = ((cells[..., 1] + _Y_OFF) << _Z_BITS) | (cells[..., 2] + _Z_OFF)
    in_range = (
        (cells[..., 1].abs() < _Y_OFF - 2)
        & (cells[..., 2].abs() < _Z_OFF - 2)
        & (hi < SENTINEL_KEY - 2)
    )
    ok = valid & in_range
    sent = torch.full_like(hi, SENTINEL_KEY)
    return torch.where(ok, hi, sent), torch.where(ok, lo, sent)


def _cells(xyz: torch.Tensor, cell: float) -> torch.Tensor:
    """floor(xyz / cell) as int32.  The divisor is an f32 tensor: given a Python
    scalar, PyTorch on CUDA multiplies by the reciprocal instead, which moves a
    point that lies on a cell boundary into the other cell."""
    divisor = torch.full((), cell, dtype=torch.float32, device=xyz.device)
    return torch.floor(xyz / divisor).to(torch.int32)


class HashGrid(NamedTuple):
    key_hi: torch.Tensor  # [cap] int32 sorted cell keys (sentinel tail)
    key_lo: torch.Tensor  # [cap]
    planar: torch.Tensor  # [3, cap] f32 coords in sorted order (BIG pad)
    src_idx: torch.Tensor  # [cap] int32 original point index (for prob gathers)
    valid: torch.Tensor  # [cap] bool


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def build_grid(xyz: torch.Tensor, valid: torch.Tensor, cell: float) -> HashGrid:
    """Sort points by quantized cell key; capacity rounds up to a band-block
    multiple (invalid rows carry BIG coordinates so they never match)."""
    n = xyz.shape[0]
    cap = _round_up(n, TN)
    if cap != n:
        xyz = torch.cat([xyz, xyz.new_zeros((cap - n, 3))])
        valid = torch.cat([valid, valid.new_zeros((cap - n,))])
    hi, lo = pack_cells(_cells(xyz, cell), valid)
    idx = torch.arange(cap, dtype=torch.int32, device=xyz.device)
    s_hi, s_lo, s_idx = sort_with_keys(hi, lo, idx)
    s_valid = s_hi != SENTINEL_KEY
    s_xyz = torch.where(s_valid[:, None], xyz[s_idx.long()], BIG_COORD)
    return HashGrid(
        key_hi=s_hi,
        key_lo=s_lo,
        planar=s_xyz.T.contiguous(),
        src_idx=s_idx,
        valid=s_valid,
    )


class PreparedQueries(NamedTuple):
    """Cell-sorted query points + per-tile band corner keys.

    The cell packing is origin-free, so one preparation serves every neighbor
    grid (LiDAL reuses it across all 24 neighbors of a frame)."""

    q_t: torch.Tensor  # [3, p] queries in cell-key order
    s_qidx: torch.Tensor  # [p] original index per sorted slot
    s_ok: torch.Tensor  # [p]
    kmin_hi: torch.Tensor  # [tiles] band-start corner key per query tile
    kmin_lo: torch.Tensor  # [tiles]
    kmax_hi: torch.Tensor  # [tiles] band-end (exclusive) corner key
    kmax_lo: torch.Tensor  # [tiles]


def _corner_keys(s_hi: torch.Tensor, s_lo: torch.Tensor):
    """Per-tile band corner keys from sorted query keys.

    Band start: lower bound of the first query's (-1, -1, -1) corner probe;
    band end: lower bound of the last query's exclusive (+1, +1, +2) corner.
    Sentinel boundaries keep the sentinel key (bands collapse onto the table's
    sentinel tail); shifts are carry-free by the pack margins."""
    p = s_hi.shape[0]
    tiles = -(-p // TILE)
    first = torch.arange(tiles, device=s_hi.device) * TILE
    last = torch.clamp_max(first + TILE - 1, p - 1)
    f_hi, f_lo = s_hi[first], s_lo[first]
    l_hi, l_lo = s_hi[last], s_lo[last]
    f_real = f_hi != SENTINEL_KEY
    l_real = l_hi != SENTINEL_KEY
    sent = torch.full_like(f_hi, SENTINEL_KEY)
    kmin_hi = torch.where(f_real, f_hi - 1, sent)
    kmin_lo = torch.where(f_real, f_lo - (1 << _Z_BITS) - 1, sent)
    kmax_hi = torch.where(l_real, l_hi + 1, sent)
    kmax_lo = torch.where(l_real, l_lo + (1 << _Z_BITS) + 2, sent)
    return kmin_hi, kmin_lo, kmax_hi, kmax_lo


def prepare_queries(q_xyz: torch.Tensor, q_valid: torch.Tensor, cell: float) -> PreparedQueries:
    p = q_xyz.shape[0]
    q_hi, q_lo = pack_cells(_cells(q_xyz, cell), q_valid)
    qidx = torch.arange(p, dtype=torch.int32, device=q_xyz.device)
    s_hi, s_lo, s_qidx = sort_with_keys(q_hi, q_lo, qidx)
    s_ok = s_hi != SENTINEL_KEY
    q_t = q_xyz[s_qidx.long()].T.contiguous()  # [3, p]
    kmin_hi, kmin_lo, kmax_hi, kmax_lo = _corner_keys(s_hi, s_lo)
    return PreparedQueries(
        q_t=q_t, s_qidx=s_qidx, s_ok=s_ok,
        kmin_hi=kmin_hi, kmin_lo=kmin_lo, kmax_hi=kmax_hi, kmax_lo=kmax_lo,
    )


def prepared_from_grid(grid: HashGrid) -> PreparedQueries:
    """Use an already-built hash grid AS the prepared query set: a grid IS a
    cell-sort (planar coords = sorted xyz, src_idx = unsort permutation), so a
    frame resident as a ring neighbor needs no re-upload and no re-sort to be
    scored as the query (the LiDAL runner's steady state: each frame uploads
    once, serves as query once and as neighbor 24 times).

    Invalid rows carry BIG coordinates here (raw pad zeros in
    :func:`prepare_queries`): both are unmatched, results identical on the
    valid set."""
    kmin_hi, kmin_lo, kmax_hi, kmax_lo = _corner_keys(grid.key_hi, grid.key_lo)
    return PreparedQueries(
        q_t=grid.planar, s_qidx=grid.src_idx, s_ok=grid.valid,
        kmin_hi=kmin_hi, kmin_lo=kmin_lo, kmax_hi=kmax_hi, kmax_lo=kmax_lo,
    )


def band_bounds(grids: HashGrid, pq: PreparedQueries):
    """Block-rounded band [blo, blo + nb) per (neighbor slot, query tile).

    ``grids`` is a stacked HashGrid (leading S axis on every field).  The two
    lower bounds per tile are ``torch.searchsorted`` over the int64 form of the
    (hi, lo) keys, the same insertion points as the JAX package's binary
    search over the pairs."""
    s, cap = grids.key_hi.shape
    nblk = cap // TN
    tiles = pq.kmin_hi.shape[0]
    table = key64(grids.key_hi, grids.key_lo)  # [S, cap]
    b_lo = torch.searchsorted(table, key64(pq.kmin_hi, pq.kmin_lo)[None].expand(s, tiles).contiguous())
    b_hi = torch.searchsorted(table, key64(pq.kmax_hi, pq.kmax_lo)[None].expand(s, tiles).contiguous())
    blo = torch.clamp_max(b_lo // TN, max(nblk - 1, 0))
    bhi_blk = torch.clamp_max(-(-b_hi // TN), nblk)
    nb = torch.clamp_min(bhi_blk - blo, 0)
    return blo.to(torch.int32), nb.to(torch.int32)


def stack_grids(grids: Sequence[HashGrid]) -> HashGrid:
    """Stack per-neighbor grids on a leading slot axis."""
    return HashGrid(*(torch.stack(xs) for xs in zip(*grids)))


def nn_query_band(grids: HashGrid, pq: PreparedQueries):
    """Band NN for all stacked neighbor slots at once (one kernel launch).

    Returns (best_d2 [S, p] f32, best_row [S, p] i32) in SORTED query order.
    Exact for matches (d <= cell); unmatched entries hold whatever band
    candidate won (or inf when the band is empty).  A query count that is not a
    multiple of TILE is padded with BIG coordinates, which match nothing real."""
    p = pq.q_t.shape[1]
    blo, nb = band_bounds(grids, pq)
    q_t = pq.q_t
    pp = _round_up(p, TILE)
    if pp != p:
        q_t = torch.cat([q_t, q_t.new_full((3, pp - p), BIG_COORD)], dim=1)
    d2, row = cuda_nnband.nn_band(grids.planar, q_t.contiguous(), blo, nb)
    return d2[:, :p], row[:, :p]


def nn_query(
    grid: HashGrid,
    q_xyz: torch.Tensor,  # [p, 3] float32 (same global coordinate system)
    q_valid: torch.Tensor,  # [p]
    cell: float,
):
    """Single-grid convenience wrapper in ORIGINAL query order.

    Returns (dist [p] f32, nn_src [p] i32 original neighbor index, found [p]
    bool).  ``found`` means a within-``cell`` match exists, exactly the
    KD-tree's ``dist <= thresh`` set; dist/nn_src are exact where found."""
    pq = prepare_queries(q_xyz, q_valid, cell)
    d2, row = nn_query_band(stack_grids([grid]), pq)
    d2, row = d2[0], row[0]
    cap = grid.src_idx.shape[0]
    dist_s = torch.sqrt(d2)
    found_s = (dist_s <= torch.full((), cell, dtype=torch.float32, device=d2.device)) & pq.s_ok
    src_s = torch.where(found_s, grid.src_idx[row.clamp_max(cap - 1).long()], 0)
    # s_qidx is a permutation: one indexed write puts the results back in input order
    order = pq.s_qidx.long()
    dist, nn_src, found = torch.empty_like(dist_s), torch.empty_like(src_s), torch.empty_like(found_s)
    dist[order], nn_src[order], found[order] = dist_s, src_s, found_s
    return dist, nn_src, found
