"""Port parity: the frame-level scorers and selectors
(``lidal_tpu_torch/active/frame_level.py``) and the ReDAL functions
(``active/redal.py``) against the JAX package on the same arrays.

The three device scorers are f32 means over ~10^3 points of per-point values in
[0, log C]: within 1e-6 of ``lidal_tpu.active.frame_level`` (another order of
the f32 sums).  Everything else is host numpy copied line for line: equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.active import frame_level as jfl, redal as jredal
from lidal_tpu_torch.active import frame_level as fl, redal

SCORERS = ["entropy_score", "margin_score", "least_confidence_score"]


def _prob(seed, p=1500, c=19, zeros=False):
    rng = np.random.default_rng(seed)
    prob = rng.dirichlet(0.3 * np.ones(c), p).astype(np.float32)
    if zeros:  # exact zeros and a one-hot row: 0 * log 0 counts as 0
        prob[::7, 3] = 0.0
        prob[5] = np.eye(c, dtype=np.float32)[2]
    return prob


@pytest.mark.parametrize("name", SCORERS)
@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_scorers_match_jax(name, zeros, with_valid):
    prob = _prob(3, zeros=zeros)
    valid = np.random.default_rng(4).random(len(prob)) < 0.7 if with_valid else None
    want = float(getattr(jfl, name)(jnp.asarray(prob), None if valid is None else jnp.asarray(valid)))
    got = getattr(fl, name)(torch.from_numpy(prob), None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == ()
    assert np.isfinite(float(got)) and abs(float(got) - want) <= 1e-6


@pytest.mark.parametrize("name", SCORERS)
def test_scorers_on_no_valid_point_and_other_dtypes(name):
    prob = _prob(5, p=64)
    none = np.zeros(64, bool)
    want = float(getattr(jfl, name)(jnp.asarray(prob), jnp.asarray(none)))
    assert float(getattr(fl, name)(torch.from_numpy(prob), torch.from_numpy(none))) == want == 0.0
    # a float64 map is scored in f32, as the JAX functions do
    got = getattr(fl, name)(torch.from_numpy(prob.astype(np.float64)))
    assert got.dtype == torch.float32 and abs(float(got) - float(getattr(jfl, name)(jnp.asarray(prob)))) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_entropy_score_equals_jax(seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 19, 700).astype(np.int32)
    point2sv = rng.integers(-1, 9, 700).astype(np.int32)
    assert fl.segment_entropy_score(pred, point2sv, 19) == jfl.segment_entropy_score(pred, point2sv, 19)
    assert fl.segment_entropy_score(pred[:0], point2sv[:0], 19) == 0.0
    assert fl.segment_entropy_score(pred, np.full(700, -1, np.int32), 19) == 0.0


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("n,frac", [(300, 0.01), (40, 0.1), (16, 0.01)])
def test_select_top_frames_equals_jax(n, frac, largest):
    rng = np.random.default_rng(n)
    flag, scores = rng.random(n) < 0.1, rng.random(n).astype(np.float32)
    got = fl.select_top_frames(flag, scores, frac=frac, largest=largest)
    np.testing.assert_array_equal(got, jfl.select_top_frames(flag, scores, frac=frac, largest=largest))
    assert got.sum() == flag.sum() + int(round(frac * n)) and got[flag].all()
    np.testing.assert_array_equal(
        fl.select_top_frames_reference(flag, largest=largest, frac=frac),
        jfl.select_top_frames_reference(flag, largest=largest, frac=frac),
    )


@pytest.mark.parametrize("seed", [0, 7])
def test_select_random_frames_and_core_set_equal_jax(seed):
    rng = np.random.default_rng(seed)
    flag = rng.random(400) < 0.05
    got = fl.select_random_frames(flag, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(got, jfl.select_random_frames(flag, rng=np.random.default_rng(seed)))
    np.testing.assert_array_equal(fl.select_random_frames(flag), jfl.select_random_frames(flag))  # the default generator
    assert got[flag].all() and flag.sum() < got.sum() <= flag.sum() + 4
    feats = rng.normal(size=(400, 96)).astype(np.float32)
    np.testing.assert_array_equal(fl.core_set_select(feats, flag), jfl.core_set_select(feats, flag))
    with pytest.raises(ValueError):
        fl.core_set_select(feats, np.zeros(400, bool))


def test_redal_constants_and_point_scores_equal_jax():
    for name in ("ALPHA", "BETA", "GAMMA", "NUM_CLUSTERS", "DECAY_RATE", "TRIM_RATE", "FT_DIM"):
        assert getattr(redal, name) == getattr(jredal, name)
    rng = np.random.default_rng(1)
    prob, curvature = _prob(6, p=500), rng.random(500).astype(np.float32) * 0.1
    score = redal.point_information_score(prob, curvature)
    np.testing.assert_array_equal(score, jredal.point_information_score(prob, curvature))
    outfeat = rng.normal(size=(500, 96)).astype(np.float32)
    point2sv = rng.integers(-1, 6, 500).astype(np.int32)
    for g, w in zip(redal.sv_scores_and_feats(score, outfeat, point2sv, 7), jredal.sv_scores_and_feats(score, outfeat, point2sv, 7)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("n,k", [(600, 150), (90, 150), (40, 5)])
def test_redal_kmeans_and_selection_equal_jax(n, k):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 16))
    np.testing.assert_array_equal(redal.kmeans_labels(x, k, seed=3), jredal.kmeans_labels(x, k, seed=3))
    flags = (rng.random(n) < 0.1).astype(np.int32)
    scores, feats = rng.random(n).astype(np.float32), rng.normal(size=(n, 96)).astype(np.float32)
    pnums = rng.integers(10, 60, n)
    got = redal.select(flags, scores, feats, pnums, train_point_num=400 * n)
    want = jredal.select(flags, scores, feats, pnums, train_point_num=400 * n)
    np.testing.assert_array_equal(got.sv_flags, want.sv_flags)
    np.testing.assert_array_equal(got.added, want.added)
    assert len(got.added) > 0
    np.testing.assert_array_equal(
        redal.select_random_svs(flags, pnums, 400 * n, rng=np.random.default_rng(2)),
        jredal.select_random_svs(flags, pnums, 400 * n, rng=np.random.default_rng(2)),
    )
    np.testing.assert_array_equal(redal.select_random_svs(flags, pnums, 400 * n), jredal.select_random_svs(flags, pnums, 400 * n))
