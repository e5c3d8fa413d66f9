"""The pruned scan of the ``nn_band`` kernel (``lidal_tpu_torch/csrc/nn_band.cu``),
emulated in torch on the CPU, against the port's plain version and the JAX
package.

The emulation takes the kernel's algorithm step by step: windows of
``WINDOW`` staged rows, boxes of ``GROUP`` rows, per warp of 32 queries a visiting
order by buckets of the groups' distance from the warp's query box (ascending
rows inside a bucket; at each bucket's start the groups whose distance from
that box exceeds the warp's largest best are dropped), the lower bound per lane with the kernel's rounding
(axis gaps fl(lo - q) / fl(q - hi), then ``(gx*gx + gy*gy) + gz*gz``, every
op an f32 op of its own), the skip rule (a warp skips a group only when every
lane's bound is strictly above its best) and the tie rule (a group scanned in
descending rows against ``thr``, which is best where the lane's best row lies
above the group and the next float below best where it lies below).

Tolerances: against ``nn_band_plain``, ``d2`` and ``row`` bit-equal.  Against
``nn_band_xla`` and interpret-mode ``nn_band_pallas``, as in
``test_torch_nn_match.py``: ``row`` and the match mask equal, ``d2`` within
2 ulp (XLA on the CPU contracts the sum into FMAs) and bit-equal on the
lattice of 1/64 m, where every product and sum is exact.
"""

import math

import numpy as np
import pytest
import torch

from lidal_tpu.active import nn_match as jax_nn
from lidal_tpu.ops import pallas_nnband as jax_band
from lidal_tpu_torch.active import nn_match
from lidal_tpu_torch.ops import cuda_nnband
from lidal_tpu_torch.ops.cuda_nnband import BIG_COORD, GROUP, TILE, TN, WINDOW
from tests.test_torch_nn_match import BAND_CASES, _both, _cloud, _ulps, _valid

EDGES = (0.01, 0.04, 0.16, 0.64, math.inf)  # the kernel's buckets (squared metres)


def _below(best: torch.Tensor) -> torch.Tensor:
    """The largest f32 below each best >= 0 (inf -> FLT_MAX), -1 at 0."""
    down = (best.view(torch.int32) - 1).view(torch.float32)
    return torch.where(best > 0, down, torch.full_like(best, -1.0))


def _gap(q, lo, hi):
    return torch.where(q < lo, lo - q, torch.where(q > hi, q - hi, torch.zeros_like(q)))


def _dist2(dx, dy, dz):
    return (dx * dx + dy * dy) + dz * dz


def lower_bound(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The kernel's bound for queries q [3, L] against one box lo, hi [3]."""
    return _dist2(*(_gap(q[a], lo[a], hi[a]) for a in range(3)))


def pruned_scan(tbl, q_t, blo, nb):
    """(d2 [S, p], row [S, p], pairs evaluated, needed [S, p]) as the kernel
    computes them."""
    s_n, _, cap = tbl.shape
    p = q_t.shape[1]
    nblk = cap // TN
    d2_out = torch.empty((s_n, p), dtype=torch.float32)
    row_out = torch.empty((s_n, p), dtype=torch.int32)
    needed = torch.zeros((s_n, p), dtype=torch.int32)
    pairs = 0
    for s in range(s_n):
        for t in range(p // TILE):
            b0 = max(0, min(int(blo[s, t]), nblk))
            n = max(0, min(int(nb[s, t]), nblk - b0))
            for w in range(TILE // 32):
                cols = slice(t * TILE + 32 * w, t * TILE + 32 * w + 32)
                q = q_t[:, cols]
                wl, wh = q.amin(dim=1), q.amax(dim=1)
                best = torch.full((32,), math.inf)
                best_row = torch.full((32,), -1, dtype=torch.int32)
                need_count = torch.zeros(32, dtype=torch.int32)
                for c0 in range(0, n, WINDOW // TN):
                    chunks = min(WINDOW // TN, n - c0)
                    row0 = (b0 + c0) * TN
                    rows = tbl[s, :, row0 : row0 + chunks * TN].reshape(3, -1, GROUP)
                    lo, hi = rows.amin(dim=2), rows.amax(dim=2)  # [3, groups]
                    gw = torch.clamp_min(torch.maximum(lo - wh[:, None], wl[:, None] - hi), 0.0)
                    dw = _dist2(gw[0], gw[1], gw[2])
                    bucket = torch.full(dw.shape, len(EDGES) - 1)
                    for e in range(len(EDGES) - 2, -1, -1):
                        bucket = torch.where(dw <= EDGES[e], e, bucket)
                    for b in range(len(EDGES)):
                        worst = best.max()  # a group whose warp bound exceeds it is excluded for every lane
                        for g in torch.nonzero((bucket == b) & ~(dw > worst)).flatten().tolist():
                            need = ~(lower_bound(q, lo[:, g], hi[:, g]) > best)
                            need_count += need.int()
                            if not bool(need.any()):
                                continue
                            pairs += GROUP * 32
                            base = row0 + g * GROUP
                            thr = torch.where(best_row > base, best, _below(best))
                            before = best_row.clone()
                            for k in range(GROUP - 1, -1, -1):
                                d2 = _dist2(*(rows[a, g, k] - q[a] for a in range(3)))
                                upd = d2 <= thr
                                thr = torch.where(upd, d2, thr)
                                best_row = torch.where(upd, base + k, best_row).to(torch.int32)
                            best = torch.where(best_row != before, thr, best)
                d2_out[s, cols] = best
                row_out[s, cols] = best_row.clamp_min(0)
                needed[s, cols] = need_count
    return d2_out, row_out, pairs, needed


def _hold_to_plain(args):
    d2, row, pairs, needed = pruned_scan(*args)
    d2_p, row_p = cuda_nnband.nn_band_plain(*args)
    assert torch.equal(d2, d2_p) and torch.equal(row, row_p)
    band_pairs = int(args[3].long().sum()) * TN * TILE
    assert 0 <= pairs <= band_pairs
    return d2, row, pairs, needed


@pytest.mark.parametrize("name", sorted(BAND_CASES))
def test_pruned_scan_matches_plain_xla_and_interpret_pallas(name):
    n, p, extent, offset, lattice = BAND_CASES[name]
    seed = 10 + sorted(BAND_CASES).index(name)
    nei = [_cloud(seed, n, extent, offset, lattice), _cloud(seed + 100, n // 2, extent, offset, lattice)]
    nei[1] = np.concatenate([nei[1], np.zeros((n - n // 2, 3), np.float32)])
    nv = [_valid(n, n), _valid(n, n // 2)]
    q, qv = _cloud(seed + 200, p, extent, offset, lattice), _valid(p, p - 5)
    gj, gt, pj, pt = _both(nei, nv, q, qv)
    blo, nb = nn_match.band_bounds(gt, pt)
    d2, row, _, _ = _hold_to_plain((gt.planar, pt.q_t, blo, nb))

    blo_j, nb_j = jax_nn.band_bounds(gj, pj)
    x_d2, x_row = jax_band.nn_band_xla(gj.planar, pj.q_t, blo_j, nb_j)
    k_d2, k_row = jax_band.nn_band_pallas(gj.planar, pj.q_t, blo_j, nb_j, interpret=True)
    thresh = np.float32(0.1)
    for ref_d2, ref_row in ((x_d2, x_row), (k_d2, k_row)):
        np.testing.assert_array_equal(row.numpy(), np.asarray(ref_row))
        np.testing.assert_array_equal(np.sqrt(d2.numpy()) <= thresh, np.sqrt(np.asarray(ref_d2)) <= thresh)
        assert _ulps(d2.numpy(), ref_d2) <= (0 if lattice else 2)


def test_pruned_scan_skips_groups_on_registered_frames():
    """Frames that see one world: most groups of a band are excluded."""
    rng = np.random.default_rng(5)
    world = (rng.random((3000, 3)) * np.array([4.0, 4.0, 1.0])).astype(np.float32)
    frames = [world + rng.normal(scale=0.01, size=world.shape).astype(np.float32) for _ in range(2)]
    valid = torch.ones(len(world), dtype=torch.bool)
    grids = nn_match.stack_grids([nn_match.build_grid(torch.from_numpy(frames[1]), valid, 0.1)])
    pq = nn_match.prepared_from_grid(nn_match.build_grid(torch.from_numpy(frames[0]), valid, 0.1))
    blo, nb = nn_match.band_bounds(grids, pq)
    args = (grids.planar, pq.q_t, blo, nb)
    band_pairs = int(nb.long().sum()) * TN * TILE
    d2, _, pairs, needed = _hold_to_plain(args)
    assert pairs < 0.5 * band_pairs
    matched = (torch.sqrt(d2) <= torch.full((), 0.1)) & pq.s_ok
    band_groups = nb.repeat_interleave(TILE, dim=1) * (TN // GROUP)
    assert 0.5 < float(matched.float().mean()) and bool((needed <= band_groups).all())
    assert float(needed[matched].float().mean()) < float(band_groups[matched].float().mean())


def _one_slot(rows: dict, queries, cap=2048, nblocks=None):
    """A table of BIG rows with the given rows set, one tile of queries (the
    rest of the tile at the first query), the band over the whole table."""
    tbl = torch.full((1, 3, cap), BIG_COORD)
    for r, xyz in rows.items():
        tbl[0, :, r] = torch.tensor(xyz, dtype=torch.float32)
    q = torch.tensor(queries, dtype=torch.float32).T
    q = torch.cat([q, q[:, :1].expand(3, TILE - q.shape[1])], dim=1).contiguous()
    nb = cap // TN if nblocks is None else nblocks
    return tbl, q, torch.zeros((1, 1), dtype=torch.int32), torch.full((1, 1), nb, dtype=torch.int32)


_F01 = np.float32(0.1)
_BELOW, _ABOVE = float(np.nextafter(_F01, np.float32(0))), float(np.nextafter(_F01, np.float32(1)))

EDGE_CASES = {
    # a tie at rows 0 and 1040: the group of row 1040 holds the query in its box and is visited first
    "tie_split_across_groups": ({**{r: (0.3, 0, 0) for r in range(32)}, **{r: (0.35, 0, 0) for r in range(1024, 1056)},
                                 1040: (-0.3, 0, 0)}, [(0, 0, 0)], 0),
    # a tie at rows 3 and 1030 in two windows' worth of groups, and a nearer row 900 in between
    "tie_lowest_row": ({1030: (0.05, 0, 0), 3: (-0.05, 0, 0), 900: (0, 0.06, 0)}, [(0, 0, 0)], 3),
    "pair_at_0.1m_minus_1ulp": ({5: (_BELOW, 0, 0), 40: (0.2, 0, 0)}, [(0, 0, 0)], 5),
    "pair_at_0.1m_plus_1ulp": ({5: (_ABOVE, 0, 0), 40: (0.2, 0, 0)}, [(0, 0, 0)], 5),
    # queries on the faces and corners of a group's box
    "queries_on_box_faces": ({**{r: (0.1 * (r % 4), 0.05 * (r % 3), -0.02 * (r % 5)) for r in range(64, 96)}},
                             [(0.0, 0.0, 0.0), (0.3, 0.1, -0.08), (0.3, 0.0, 0.0), (0.15, 0.1, -0.08)], None),
    "negative_coords": ({r: (-5.0 - 0.01 * r, -3.0 + 0.002 * r, -1.0) for r in range(0, 600, 7)},
                        [(-5.5, -2.5, -1.0), (-5.01, -2.99, -1.0), (-7.0, -3.0, -1.2)], None),
    # real rows and BIG rows in one group (the table's tail): its box is 1e9 wide and never pruned
    "big_rows_in_a_group": ({**{r: (0.01 * r, 0.0, 0.0) for r in range(1000, 1040)}}, [(10.0, 0, 0), (0.2, 0, 0)], None),
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_pruned_scan_edge_cases(name):
    rows, queries, want_row = EDGE_CASES[name]
    d2, row, _, _ = _hold_to_plain(_one_slot(rows, queries))
    if want_row is not None:
        assert int(row[0, 0]) == want_row
    if name.startswith("pair_at"):
        matched = bool(torch.sqrt(d2[0, 0]) <= torch.full((), 0.1))
        assert matched == name.endswith("minus_1ulp")


def test_pruned_scan_empty_bands_and_padded_queries():
    """Empty bands give (inf, 0); queries at BIG_COORD (padding) find the BIG
    rows at 0 and prune every real group."""
    tbl, q, blo, nb = _one_slot({r: (0.05 * r, 0, 0) for r in range(0, 300, 3)}, [(1.0, 0, 0)])
    q[:, 200:] = BIG_COORD
    tbl2 = torch.cat([tbl, tbl.flip(2)])
    q2 = torch.cat([q, q], dim=1)
    blo2 = torch.tensor([[0, 0], [1, 1]], dtype=torch.int32)
    nb2 = torch.tensor([[0, 2], [1, 1]], dtype=torch.int32)
    d2, row, _, _ = _hold_to_plain((tbl2, q2, blo2, nb2))
    assert bool(torch.isinf(d2[0, :TILE]).all()) and not bool(row[0, :TILE].any())
    assert bool((d2[0, TILE + 200 :] == 0).all())


def test_lower_bound_never_exceeds_a_row_distance():
    """LB <= d2 for every row of every box, bit for bit, on seeded inputs:
    boxes of nearby rows, rows an ulp apart, negative coordinates, BIG rows,
    queries inside, outside and on the faces."""
    rng = np.random.default_rng(2024)
    checked = 0
    for trial in range(200):
        scale = [1e-3, 0.1, 3.0, 50.0][trial % 4]
        centre = rng.normal(scale=20.0, size=3)
        rows = (centre + rng.normal(scale=scale, size=(GROUP, 3))).astype(np.float32)
        if trial % 5 == 0:
            rows[: trial % 7 + 1] = BIG_COORD
        if trial % 3 == 0:  # rows an ulp or two apart
            rows = np.nextafter(rows[:1], np.float32(np.inf)).repeat(GROUP, 0)
            rows[::2] = np.nextafter(rows[::2], np.float32(-np.inf))
        lo, hi = rows.min(0), rows.max(0)
        qs = np.concatenate([
            (centre + rng.normal(scale=4 * scale, size=(24, 3))).astype(np.float32),
            np.stack([lo, hi, np.nextafter(lo, np.float32(-np.inf)), np.nextafter(hi, np.float32(np.inf))]),
            rows[rng.integers(0, GROUP, 4)],
        ]).astype(np.float32)
        q = torch.from_numpy(qs.T.copy())
        lb = lower_bound(q, torch.from_numpy(lo), torch.from_numpy(hi))
        t = torch.from_numpy(rows.T.copy())
        d2 = _dist2(*(t[a][None, :] - q[a][:, None] for a in range(3)))  # [queries, rows]
        assert bool((lb[:, None] <= d2).all()), trial
        checked += d2.numel()
    assert checked == 200 * 32 * GROUP


@pytest.mark.parametrize("case", ["registered_frames", "tie_split_across_groups", "empty_bands_and_padded_queries"])
def test_bound_counts_the_groups_no_exact_scan_may_skip(case):
    """``chip_smoke.nn_band_groups_needed``, the pairs behind phase 11's bound:
    per (slot, query) at most the groups the emulated kernel's lane needed, at
    least the group of its answer's row where the band is not empty, and the
    rows of those groups alone give the plain version's answer."""
    from chip_smoke import nn_band_groups_needed

    if case == "registered_frames":
        rng = np.random.default_rng(8)
        world = (rng.random((3000, 3)) * np.array([4.0, 4.0, 1.0])).astype(np.float32)
        frames = [world + rng.normal(scale=0.01, size=world.shape).astype(np.float32) for _ in range(3)]
        valid = torch.ones(len(world), dtype=torch.bool)
        grids = nn_match.stack_grids([nn_match.build_grid(torch.from_numpy(f), valid, 0.1) for f in frames[1:]])
        pq = nn_match.prepared_from_grid(nn_match.build_grid(torch.from_numpy(frames[0]), valid, 0.1))
        args = (grids.planar, pq.q_t, *nn_match.band_bounds(grids, pq))
    elif case == "tie_split_across_groups":
        args = _one_slot(*EDGE_CASES[case][:2])
    else:
        tbl, q, _, _ = _one_slot({r: (0.05 * r, 0, 0) for r in range(0, 300, 3)}, [(1.0, 0, 0)])
        q[:, 200:] = BIG_COORD
        args = (torch.cat([tbl, tbl.flip(2)]), torch.cat([q, q], dim=1),
                torch.tensor([[0, 0], [1, 1]], dtype=torch.int32), torch.tensor([[0, 2], [1, 1]], dtype=torch.int32))
    d2, row, _, needed = _hold_to_plain(args)
    floor = nn_band_groups_needed(*args, d2)
    assert floor.dtype == torch.int32 and floor.shape == d2.shape
    assert bool((floor <= needed).all())
    tbl, q_t, blo, nb = args
    band = nb.repeat_interleave(TILE, dim=1) > 0
    assert bool((floor[band] >= 1).all()) and not bool(floor[~band].any())
    # a scan of the floor's groups alone: the best row's group is among them
    per_block = TN // GROUP
    lo, hi = (f(tbl.view(tbl.shape[0], 3, -1, GROUP), dim=3) for f in (torch.amin, torch.amax))
    for s, j in zip(*torch.nonzero(band, as_tuple=True)):
        t, g = int(j) // TILE, int(row[s, j]) // GROUP
        assert int(blo[s, t]) * per_block <= g < int(blo[s, t] + nb[s, t]) * per_block
        assert bool(lower_bound(q_t[:, j, None], lo[s, :, g], hi[s, :, g])[0] <= d2[s, j])
