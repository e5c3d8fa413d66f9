"""Port parity of ``lidal_tpu_torch/active/lidal.py`` and of the neighbour ring
(``active/lidal_runner.NeighborRing``) against the JAX package on the CPU.

Tolerances: ``interd`` / ``intere`` within 1e-5 * max(1, |jax|): both sum the
slots in the same order in f32, but ``log`` differs in its last bits between
XLA and torch, and ``d2`` by up to 2 ulp (``tests/test_torch_nn_match.py``).
Ring contents (keys, coords, grid-sorted probs), neighbour ids, supervoxel
aggregates and selection flags are equal: integer outputs or numpy host code
copied line for line.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.active import lidal as jax_lidal
from lidal_tpu.active.lidal_runner import NeighborRing as JaxRing
from lidal_tpu_torch.active import lidal
from lidal_tpu_torch.active.lidal_runner import NeighborRing


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(1.0, np.abs(want))), float(np.abs(got - want).max())


def _frames(seed, n_frames, n, c, drift=0.3, jitter=0.05, extent=4.0):
    """Frames that see one base cloud from a drifting origin, so neighbours match."""
    rng = np.random.default_rng(seed)
    base = (rng.random((n, 3)) * extent - extent / 2).astype(np.float32)
    out = []
    for i in range(n_frames):
        xyz = base + np.array([drift * i, 0, 0], np.float32)
        xyz += rng.normal(scale=jitter, size=xyz.shape).astype(np.float32)
        out.append((xyz, rng.dirichlet(np.ones(c), n).astype(np.float32)))
    return out


@pytest.mark.parametrize("seed,n,c,k", [(3, 300, 7, 4), (4, 256, 19, 3)])
def test_score_frame_matches_jax(seed, n, c, k):
    frames = _frames(seed, k + 1, n, c, drift=0.0, jitter=0.04)
    q_xyz, q_prob = frames[0]
    nei = frames[1:]
    gj = [jax_lidal.make_neighbor_grid(x) for x, _ in nei]
    gt = [lidal.make_neighbor_grid(x, device="cpu") for x, _ in nei]
    want_d, want_e = jax_lidal.score_frame(q_prob, q_xyz, [p for _, p in nei], gj)
    got_d, got_e = lidal.score_frame(q_prob, q_xyz, [p for _, p in nei], gt)
    assert (want_d > 0).mean() > 0.3  # the neighbours do match
    _close(got_d, want_d)
    _close(got_e, want_e)


@pytest.mark.parametrize("n_frames,fi,nei_num", [(8, 4, 4), (3, 0, 4), (9, 8, 6)])
def test_ring_and_score_slot_match_jax(n_frames, fi, nei_num):
    """The ring path: same slot contents as the JAX ring, and the same scores,
    with duplicate neighbours (ids clamped or reflected at a sequence end)
    carried by the weights and the query's own slot at weight 0."""
    c, n = 6, 220
    frames = _frames(21 + n_frames, n_frames, n, c, drift=0.0, jitter=0.03)
    nei = lidal.neighbor_ids(fi, n_frames, nei_num=nei_num)
    assert nei == jax_lidal.neighbor_ids(fi, n_frames, nei_num=nei_num)
    if n_frames == 3:
        assert len(set(nei)) < len(nei)  # duplicates

    jring = JaxRing(nei_num + 2, cap=n, device=None)
    jring.ensure([fi] + nei, lambda k: frames[k])
    ring = NeighborRing(nei_num + 2, cap=n, device="cpu")
    ring.ensure([fi] + nei, lambda k: frames[k])
    assert ring.key2slot == jring.key2slot
    np.testing.assert_array_equal(ring.weights(nei), jring.weights(nei))
    assert ring.weights(nei)[ring.key2slot[fi]] == 0

    (grids, probs), (jgrids, jprobs) = ring.state, jring.state
    for k, slot in ring.key2slot.items():
        for f in ("key_hi", "key_lo", "src_idx", "valid"):
            np.testing.assert_array_equal(getattr(grids, f)[slot].numpy(), np.asarray(getattr(jgrids, f))[slot])
        np.testing.assert_array_equal(grids.planar[slot].numpy(), np.asarray(jgrids.planar)[slot].reshape(3, -1))
        # rows past the point capacity (220 here, rounded up to 1024 by the grid):
        # the JAX gather clamps their index to the last point, the port pads
        # with zeros; they are invalid rows and never matched
        ok = grids.valid[slot].numpy()
        np.testing.assert_array_equal(probs[slot].numpy()[ok], np.asarray(jprobs)[slot][ok])
        assert not probs[slot].numpy()[~ok].any()
        assert ring.meta[k][0] == jring.meta[k][0] == n

    want = np.asarray(jax_lidal.score_slot(jring.state, ring.key2slot[fi], jnp.asarray(jring.weights(nei))))
    got = lidal.score_slot(ring.state, ring.key2slot[fi], ring.weights(nei)).numpy()
    assert got.shape == want.shape == (2, 1024)
    assert (want[0, :n] > 0).mean() > 0.3
    _close(got[:, :n], want[:, :n])

    # a neighbour listed twice (weight 2) counts as two neighbours: the
    # uploaded-query path with the list as it stands gives the same scores
    # (as tests/test_active.py::test_score_slot_matches_score_frame; the slots
    # are summed in another order, hence a tolerance)
    q_xyz, q_prob = frames[fi]
    d_f, e_f = lidal.score_frame(
        q_prob, q_xyz, [frames[k][1] for k in nei], [lidal.make_neighbor_grid(frames[k][0], device="cpu") for k in nei]
    )
    np.testing.assert_allclose(got[0, :n], d_f, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1, :n], e_f, rtol=1e-5, atol=1e-6)


def test_ring_device_prob_equals_uploaded_prob():
    """The fused round hands the ring a prob map that is already a tensor of
    the full point capacity; the slot must equal the staged path's upload,
    pad rows zeroed."""
    n, cap, c = 200, 256, 5
    (xyz, prob), = _frames(5, 1, n, c)
    staged, fused = NeighborRing(3, cap, device="cpu"), NeighborRing(3, cap, device="cpu")
    staged.ensure([0], lambda k: (xyz, prob))
    dev_prob = torch.full((cap, c), 0.25)
    dev_prob[:n] = torch.from_numpy(prob)
    fused.ensure([0], lambda k: (xyz, dev_prob))
    for a, b in zip(staged.state[0] + (staged.state[1],), fused.state[0] + (fused.state[1],)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fid,n", [(50, 1000), (0, 1000), (999, 1000), (3, 30), (29, 30), (1, 5)])
def test_neighbor_ids_equal_jax(fid, n):
    assert lidal.neighbor_ids(fid, n) == jax_lidal.neighbor_ids(fid, n)


def _select_cases():
    far = np.array([[0, 0, 0], [100, 0, 0], [102, 0, 0], [200, 0, 0], [300, 0, 0]], np.float32)
    yield "handcrafted", (np.zeros(5, np.int64), np.array([5.0, 4.0, 3.0, 2.0, 1.0], np.float32),
                          np.array([0.1, 0.2, 0.9, 0.3, 0.4], np.float32), np.full(5, 10, np.int64), far, 2000)
    three = np.array([[0, 0, 0], [100, 0, 0], [200, 0, 0]], np.float32)
    yield "skips_zero_divergence", (np.zeros(3, np.int64), np.array([3.0, 0.0, 1.0], np.float32),
                                    np.full(3, 0.5, np.float32), np.full(3, 10, np.int64), three, 1000)
    yield "excludes_previous_pseudo", (np.array([0, 2, 0], np.int64), np.array([5.0, 1.0, 2.0], np.float32),
                                       np.full(3, 0.5, np.float32), np.full(3, 10, np.int64), three, 1000)
    rng = np.random.default_rng(4)
    n = 200
    yield "budget", (np.zeros(n, np.int64), rng.random(n).astype(np.float32) + 0.01, rng.random(n).astype(np.float32),
                     rng.integers(50, 200, n), (rng.random((n, 3)) * 500).astype(np.float32), 100_000)
    n = 400  # crowded centres, score ties and earlier flags: swaps and the tie order matter
    flags = rng.integers(0, 3, n).astype(np.int64)
    yield "crowded_with_ties", (flags, np.round(rng.random(n), 1).astype(np.float32), rng.random(n).astype(np.float32),
                                rng.integers(5, 60, n), (rng.random((n, 3)) * 40).astype(np.float32), 300_000)


_SELECT = dict(_select_cases())


@pytest.mark.parametrize("name", sorted(_SELECT))
def test_select_flags_equal_jax(name):
    flags, interd, intere, pnums, centers, tpn = _SELECT[name]
    want = jax_lidal.select(flags.copy(), interd, intere, pnums, centers, train_point_num=tpn)
    got = lidal.select(flags.copy(), interd, intere, pnums, centers, train_point_num=tpn)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if name == "handcrafted":
        assert set(np.where(got.sv_flags == 1)[0]) == {0, 2} and set(np.where(got.sv_flags == 2)[0]) == {3, 4}
    if name == "crowded_with_ties":
        assert len(got.al_added) > 3 and len(got.sl_added) > 3


def test_sv_aggregate_equals_jax():
    rng = np.random.default_rng(5)
    p, n_sv = 300, 12
    p2s = rng.integers(-1, n_sv, p)
    interd, intere = rng.random(p).astype(np.float32), rng.random(p).astype(np.float32)
    xyz = rng.random((p, 3)).astype(np.float32)
    for args in ((interd, intere, p2s, n_sv), (interd, intere, p2s, n_sv, xyz)):
        got, want = lidal.sv_aggregate(*args), jax_lidal.sv_aggregate(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
