"""Port parity of ``lidal_tpu_torch/active/nn_match.py`` and of the plain
version of the ``nn_band`` kernel (``lidal_tpu_torch/ops/cuda_nnband.py``)
against the JAX package on the CPU.

Tolerances.  Every integer field (keys, ``src_idx``, ``valid``, ``s_qidx``,
``s_ok``, corner keys, ``blo``, ``nb``, the winning ``row``) and the match
mask ``sqrt(d2) <= 0.1`` are equal.  ``planar`` / ``q_t`` are equal floats
(permutation and padding only).  ``d2``: the port's plain version rounds every
product and sum on its own (it is bit-equal to the same expression in numpy
f32, checked here).  XLA on the CPU contracts ``dx*dx + dy*dy + dz*dz`` into
FMAs inside ``nn_band_xla``'s fused loop (found by comparison: up to 2 ulp from
the separately rounded sum, as two contractions give; a plain ``jit`` of the
expression alone is not contracted), and interpret-mode Pallas agrees with it
bit for bit, so ``d2`` is held within 2 ulp of both, and bit-equal on
coordinates that are multiples of 1/64 m, where every product and sum is exact
either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.active import nn_match as jax_nn
from lidal_tpu.ops import pallas_nnband as jax_band
from lidal_tpu_torch.active import nn_match
from lidal_tpu_torch.ops import cuda_nnband
from lidal_tpu_torch.ops.hashing import SENTINEL_KEY, key64

CELL = 0.1


def _cloud(seed, n, extent, offset=0.0, lattice=False):
    rng = np.random.default_rng(seed)
    if lattice:  # multiples of 1/64 m
        return (rng.integers(0, int(extent * 64), (n, 3)) / 64.0 + offset).astype(np.float32)
    return (rng.random((n, 3)) * extent + offset).astype(np.float32)


def _valid(n, n_valid):
    v = np.zeros(n, bool)
    v[:n_valid] = True
    return v


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    both_inf = np.isinf(a) & np.isinf(b)
    d = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    return int(np.where(both_inf, 0, d).max()) if d.size else 0


def _both(nei, nv, q, qv):
    """(stacked grids, prepared queries) of the JAX package and of the port."""
    gj = jax_nn.stack_grids([jax_nn.build_grid(jnp.asarray(x), jnp.asarray(v), CELL) for x, v in zip(nei, nv)])
    gt = nn_match.stack_grids(
        [nn_match.build_grid(torch.from_numpy(x), torch.from_numpy(v), CELL) for x, v in zip(nei, nv)]
    )
    pj = jax_nn.prepare_queries(jnp.asarray(q), jnp.asarray(qv), CELL)
    pt = nn_match.prepare_queries(torch.from_numpy(q), torch.from_numpy(qv), CELL)
    return gj, gt, pj, pt


CASES = {
    # name: (table points, valid table points, queries, valid queries, extent, offset)
    "dense": (1024, 1024, 512, 512, 3.0, 0.0),
    "negative_coords": (1024, 900, 512, 500, 4.0, -2.0),  # cells of both signs on every axis
    "far_negative": (1024, 1024, 256, 256, 3.0, -50.0),
    "shorter_than_cap": (700, 650, 300, 290, 4.0, -1.0),  # cap rounds up to 1024; p is not a TILE multiple
    "empty_table": (512, 0, 256, 256, 4.0, 0.0),
    "empty_queries": (512, 512, 256, 0, 4.0, 0.0),
    "multi_block_band": (4096, 4096, 512, 512, 2.0, -1.0),
    "sparse": (512, 512, 512, 512, 40.0, -20.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_grid_queries_and_bands_equal_jax(name):
    n, n_v, p, p_v, extent, offset = CASES[name]
    seed = sorted(CASES).index(name)
    nei = [_cloud(seed, n, extent, offset), _cloud(seed + 100, n, extent, offset)[::-1].copy()]
    nv = [_valid(n, n_v), _valid(n, n_v)]
    q, qv = _cloud(seed + 200, p, extent * 1.05, offset - 0.1), _valid(p, p_v)
    gj, gt, pj, pt = _both(nei, nv, q, qv)

    for f in ("key_hi", "key_lo", "src_idx", "valid"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)), err_msg=f)
        assert getattr(gt, f).dtype == (torch.bool if f == "valid" else torch.int32)
    s, cap = gt.key_hi.shape
    assert cap % cuda_nnband.TN == 0 and gt.planar.shape == (s, 3, cap)
    np.testing.assert_array_equal(gt.planar.numpy(), np.asarray(gj.planar).reshape(s, 3, cap))

    for f in ("s_qidx", "s_ok", "kmin_hi", "kmin_lo", "kmax_hi", "kmax_lo"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), err_msg=f)
    np.testing.assert_array_equal(pt.q_t.numpy(), np.asarray(pj.q_t)[:3])

    # a resident grid used as the query set
    fj = jax_nn.prepared_from_grid(jax_nn.HashGrid(*(np.asarray(a)[0] for a in gj)))
    ft = nn_match.prepared_from_grid(nn_match.HashGrid(*(a[0] for a in gt)))
    for f in ("s_qidx", "s_ok", "kmin_hi", "kmin_lo", "kmax_hi", "kmax_lo"):
        np.testing.assert_array_equal(getattr(ft, f).numpy(), np.asarray(getattr(fj, f)), err_msg=f)
    np.testing.assert_array_equal(ft.q_t.numpy(), np.asarray(fj.q_t)[:3])

    for pq_j, pq_t in ((pj, pt), (fj, ft)):
        blo_j, nb_j = jax_nn.band_bounds(gj, pq_j)
        blo_t, nb_t = nn_match.band_bounds(gt, pq_t)
        assert blo_t.dtype == nb_t.dtype == torch.int32
        np.testing.assert_array_equal(blo_t.numpy(), np.asarray(blo_j))
        np.testing.assert_array_equal(nb_t.numpy(), np.asarray(nb_j))


def test_key64_keeps_signed_cell_order():
    """``hi = cx`` is negative for x < 0: the int64 sort key must order
    negative cells before positive ones, as the (hi, lo) pair order does."""
    xyz = np.array([[0.55, 0, 0], [-0.55, 0, 0], [-0.05, 0.3, 0], [-0.05, -0.3, 0], [0.05, 0, -0.3], [-7.0, 1, 1]], np.float32)
    cells = nn_match._cells(torch.from_numpy(xyz), CELL)
    np.testing.assert_array_equal(cells.numpy(), np.floor(xyz / np.float32(CELL)).astype(np.int32))
    hi, lo = nn_match.pack_cells(cells, torch.ones(len(xyz), dtype=torch.bool))
    order = torch.argsort(key64(hi, lo)).tolist()
    want = sorted(range(len(xyz)), key=lambda i: tuple(cells[i].tolist()))
    assert order == want and int(hi.min()) < 0
    grid = nn_match.build_grid(torch.from_numpy(xyz), torch.ones(len(xyz), dtype=torch.bool), CELL)
    assert grid.src_idx[: len(xyz)].tolist() == want
    assert bool((grid.key_hi[len(xyz) :] == SENTINEL_KEY).all())
    assert bool((grid.planar[:, len(xyz) :] == cuda_nnband.BIG_COORD).all())


BAND_CASES = {
    # name: (table points, queries, extent, offset, lattice)
    "dense": (1024, 512, 3.0, -1.5, False),
    "multi_block": (4096, 512, 2.0, 0.0, False),
    "sparse": (1024, 256, 40.0, -20.0, False),
    "lattice_64ths": (2048, 512, 1.5, -0.75, True),  # exact arithmetic; many exact ties
}


@pytest.mark.parametrize("name", sorted(BAND_CASES))
def test_nn_band_plain_matches_xla_and_interpret_pallas(name):
    n, p, extent, offset, lattice = BAND_CASES[name]
    seed = 10 + sorted(BAND_CASES).index(name)
    nei = [_cloud(seed, n, extent, offset, lattice), _cloud(seed + 100, n // 2, extent, offset, lattice)]
    nei[1] = np.concatenate([nei[1], np.zeros((n - n // 2, 3), np.float32)])
    nv = [_valid(n, n), _valid(n, n // 2)]
    q, qv = _cloud(seed + 200, p, extent, offset, lattice), _valid(p, p - 5)
    gj, gt, pj, pt = _both(nei, nv, q, qv)
    blo_j, nb_j = jax_nn.band_bounds(gj, pj)
    blo, nb = nn_match.band_bounds(gt, pt)

    d2, row = cuda_nnband.nn_band(gt.planar, pt.q_t, blo, nb)  # a CPU tensor takes the plain version
    d2_p, row_p = cuda_nnband.nn_band_plain(gt.planar, pt.q_t, blo, nb)
    assert torch.equal(d2, d2_p) and torch.equal(row, row_p)
    assert d2.dtype == torch.float32 and row.dtype == torch.int32 and d2.shape == row.shape == (2, p)
    x_d2, x_row = jax_band.nn_band_xla(gj.planar, pj.q_t, blo_j, nb_j)
    k_d2, k_row = jax_band.nn_band_pallas(gj.planar, pj.q_t, blo_j, nb_j, interpret=True)

    thresh = np.float32(0.1)
    for ref_d2, ref_row in ((x_d2, x_row), (k_d2, k_row)):
        np.testing.assert_array_equal(row.numpy(), np.asarray(ref_row))
        np.testing.assert_array_equal(np.sqrt(d2.numpy()) <= thresh, np.sqrt(np.asarray(ref_d2)) <= thresh)
        assert _ulps(d2.numpy(), ref_d2) <= (0 if lattice else 2)

    # the plain version is the separately rounded f32 sum of the winning pair
    for s in range(2):
        nonempty = np.repeat(nb[s].numpy() > 0, cuda_nnband.TILE)
        win = gt.planar[s].numpy()[:, row[s].numpy()]
        d = win - pt.q_t.numpy()
        want = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        np.testing.assert_array_equal(d2[s].numpy()[nonempty], want[nonempty])
        assert np.isinf(d2[s].numpy()[~nonempty]).all() and not row[s].numpy()[~nonempty].any()
    if lattice:  # ties are real on the lattice: the lowest row must have won
        planar = gt.planar[0].numpy().astype(np.float64)
        qs = pt.q_t.numpy().astype(np.float64)
        for j in np.random.default_rng(0).choice(p, 32, replace=False):
            lo_r = int(blo[0, j // 256]) * 1024
            hi_r = lo_r + int(nb[0, j // 256]) * 1024
            if hi_r > lo_r:
                dd = ((planar[:, lo_r:hi_r] - qs[:, j : j + 1]) ** 2).sum(0)
                assert int(row[0, j]) == lo_r + int(np.argmin(dd))


def test_nn_band_plain_edge_cases():
    """An empty band, a table of only BIG rows, an exact tie, and a pair at
    0.1 m -+ 1 ulp, through the plain version."""
    cap, p = 1024, 256
    tbl = torch.full((4, 3, cap), cuda_nnband.BIG_COORD)
    q = torch.zeros((3, p))
    # slot 1: two points equidistant from query 0 at rows 7 and 3 -> row 3 wins
    tbl[1, :, 7] = torch.tensor([0.05, 0.0, 0.0])
    tbl[1, :, 3] = torch.tensor([-0.05, 0.0, 0.0])
    # slots 2, 3: one point whose distance from query 0 is the f32 just below / above 0.1
    below, above = np.nextafter(np.float32(0.1), np.float32(0)), np.nextafter(np.float32(0.1), np.float32(1))
    tbl[2, 0, 0], tbl[2, 1:, 0] = float(below), 0.0
    tbl[3, 0, 0], tbl[3, 1:, 0] = float(above), 0.0
    blo = torch.zeros((4, 1), dtype=torch.int32)
    nb = torch.tensor([[0], [1], [1], [1]], dtype=torch.int32)
    d2, row = cuda_nnband.nn_band(tbl, q, blo, nb)
    assert bool(torch.isinf(d2[0]).all()) and not bool(row[0].any())  # empty band: (inf, 0)
    assert int(row[1, 0]) == 3 and float(d2[1, 0]) == float(np.float32(0.05) * np.float32(0.05))
    thresh = torch.full((), 0.1)
    assert bool(torch.sqrt(d2[2, 0]) <= thresh) and not bool(torch.sqrt(d2[3, 0]) <= thresh)
    # a table of only BIG rows: a finite, huge distance, row 0, and no match
    d2b, rowb = cuda_nnband.nn_band(tbl[:1], q, blo[:1], torch.ones((1, 1), dtype=torch.int32))
    assert bool(torch.isfinite(d2b).all()) and float(d2b.min()) > 1e17 and not bool(rowb.any())


def test_nn_band_wrapper_refuses_what_it_has_no_path_for():
    tbl, q = torch.zeros((1, 3, 1024)), torch.zeros((3, 256))
    blo = nb = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent route to the plain version
        cuda_nnband.nn_band(tbl.to("meta"), q.to("meta"), blo.to("meta"), nb.to("meta"))
    with pytest.raises(ValueError):
        cuda_nnband.nn_band(tbl, torch.zeros((3, 300)), blo, nb)  # p % TILE
    with pytest.raises(ValueError):
        cuda_nnband.nn_band(torch.zeros((1, 3, 1000)), q, blo, nb)  # cap % TN
    with pytest.raises(ValueError):
        cuda_nnband.nn_band(tbl, q, torch.zeros((1, 2), dtype=torch.int32), nb)  # band table shape
    with pytest.raises(ValueError):
        cuda_nnband.nn_band(tbl, torch.zeros((4, 256)), blo, nb)  # the port's queries are [3, p]


def _brute_nn(nei, nv, q, qv, thresh):
    d2 = np.sum((q[:, None, :].astype(np.float64) - nei[None].astype(np.float64)) ** 2, axis=2)
    d2[:, ~nv] = np.inf
    idx = np.argmin(d2, axis=1)
    dist = np.sqrt(d2[np.arange(len(q)), idx])
    return dist, idx, qv & (dist <= thresh)


@pytest.mark.parametrize("seed,n,p,extent,offset", [(0, 800, 500, 4.0, -0.1), (1, 1024, 256, 3.0, -51.0), (2, 300, 300, 0.5, -0.25)])
def test_nn_query_matches_brute_force_and_jax(seed, n, p, extent, offset):
    nei, q = _cloud(seed, n, extent, offset), _cloud(seed + 50, p, extent * 1.05, offset - 0.1)
    nv, qv = _valid(n, n - 3), _valid(p, p - 2)
    grid = nn_match.build_grid(torch.from_numpy(nei), torch.from_numpy(nv), CELL)
    dist, nn_src, found = (a.numpy() for a in nn_match.nn_query(grid, torch.from_numpy(q), torch.from_numpy(qv), CELL))
    bd, bi, bm = _brute_nn(nei, nv, q, qv, CELL)
    assert bm.sum() > 10
    np.testing.assert_array_equal(found, bm)
    np.testing.assert_allclose(dist[bm], bd[bm], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(nn_src[bm], bi[bm])

    gj = jax_nn.build_grid(jnp.asarray(nei), jnp.asarray(nv), CELL)
    dj, sj, fj = (np.asarray(a) for a in jax_nn.nn_query(gj, jnp.asarray(q), jnp.asarray(qv), CELL))
    np.testing.assert_array_equal(found, fj)
    np.testing.assert_array_equal(nn_src, sj)
    assert _ulps(dist[found], dj[found]) <= 2
