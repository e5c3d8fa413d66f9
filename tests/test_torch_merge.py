"""Port parity: sorted-key lookups (``lidal_tpu_torch/ops/merge_lookup.py``,
kernel wrapper ``ops/cuda_merge.py``) are bit-equal to the JAX package's XLA
merge and to ``merge_rank_pallas`` in interpret mode.  On the CPU the wrapper
runs its plain version; ``test_torch_cuda.py`` holds the CUDA kernel against
it on the card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidal_tpu.ops.merge_lookup as ml
import lidal_tpu.ops.pallas_merge as pmerge
from lidal_tpu_torch.ops.hashing import SENTINEL_KEY
from lidal_tpu_torch.ops.merge_lookup import lookup_sorted_grouped, lower_bound_sorted_grouped
from tests.test_torch_frames import torch_args


@pytest.fixture
def pallas_merge_on(monkeypatch):
    monkeypatch.setattr(
        pmerge, "merge_rank_pallas", functools.partial(pmerge.merge_rank_pallas, interpret=True)
    )
    monkeypatch.setattr(ml, "USE_PALLAS", True)


@pytest.fixture
def xla_merge(monkeypatch):
    monkeypatch.setattr(ml, "USE_PALLAS", False)


def _table(rng, cap, n_real, lo_range=16):
    """[cap] sorted unique (hi, lo) keys, sentinel tail past n_real."""
    packed = np.unique(rng.integers(0, 60, n_real) * lo_range + rng.integers(0, lo_range, n_real))
    packed = packed[:cap]
    hi = np.full(cap, SENTINEL_KEY, np.int32)
    lo = np.full(cap, SENTINEL_KEY, np.int32)
    hi[: len(packed)] = packed // lo_range
    lo[: len(packed)] = packed % lo_range
    return hi, lo


def _streams(seed, s, cap, unique, empty_stream=None, sentinel_stream=None):
    """Per-stream tables [s, cap] and sorted query streams [s, cap].

    Unique queries are a constant offset of the stream's table (the rulebook
    pattern, offset (1, -1) borrows across the lo field); otherwise queries
    repeat and interleave with table keys."""
    rng = np.random.default_rng(seed)
    t_hi = np.empty((s, cap), np.int32)
    t_lo = np.empty((s, cap), np.int32)
    q_hi = np.empty((s, cap), np.int32)
    q_lo = np.empty((s, cap), np.int32)
    for i in range(s):
        n_real = 0 if i == empty_stream else int(rng.integers(cap // 3, cap))
        t_hi[i], t_lo[i] = _table(rng, cap, n_real)
        real = t_hi[i] != SENTINEL_KEY
        if unique:
            d_hi, d_lo = [(0, 1), (1, -1), (0, 0), (-1, 3)][i % 4]
            q_hi[i] = np.where(real, t_hi[i] + d_hi, SENTINEL_KEY)
            q_lo[i] = np.where(real, t_lo[i] + d_lo, SENTINEL_KEY)
        else:
            pick = np.sort(rng.integers(0, max(1, real.sum()), cap))
            q_hi[i] = np.where(real.any(), t_hi[i][pick], 5)
            q_lo[i] = np.where(real.any(), t_lo[i][pick] + rng.integers(-1, 2, cap), 7)
            order = np.lexsort((q_lo[i], q_hi[i]))
            q_hi[i], q_lo[i] = q_hi[i][order], q_lo[i][order]
            q_hi[i, -cap // 5 :] = SENTINEL_KEY  # sentinel tail
            q_lo[i, -cap // 5 :] = SENTINEL_KEY
        if i == sentinel_stream:
            q_hi[i] = SENTINEL_KEY
            q_lo[i] = SENTINEL_KEY
    return t_hi, t_lo, q_hi, q_lo


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), **kw))


CASES = [
    dict(seed=0, s=4, cap=384),
    dict(seed=1, s=6, cap=256, empty_stream=2),
    dict(seed=2, s=5, cap=300, sentinel_stream=1),
    dict(seed=3, s=3, cap=512, empty_stream=0, sentinel_stream=2),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("unique_queries", [True, False])
def test_lookup_bit_equal_to_xla_merge(xla_merge, case, unique_queries):
    arrays = _streams(**case, unique=unique_queries)
    got = lookup_sorted_grouped(*torch_args(*arrays)).numpy()
    want = _jax(ml.lookup_sorted_grouped, *arrays, unique_queries=unique_queries)
    np.testing.assert_array_equal(got, want)
    assert (got < case["cap"]).any() and (got == case["cap"]).any()  # hits and misses


@pytest.mark.parametrize("case", CASES)
def test_lower_bound_bit_equal_to_xla_merge(xla_merge, case):
    arrays = _streams(**case, unique=False)
    got = lower_bound_sorted_grouped(*torch_args(*arrays)).numpy()
    np.testing.assert_array_equal(got, _jax(ml.lower_bound_sorted_grouped, *arrays))


@pytest.mark.parametrize("case", CASES[:2])
@pytest.mark.parametrize("unique_queries", [True, False])
def test_lookup_bit_equal_to_pallas_interpret(pallas_merge_on, case, unique_queries):
    arrays = _streams(**case, unique=unique_queries)
    got = lookup_sorted_grouped(*torch_args(*arrays)).numpy()
    want = _jax(ml.lookup_sorted_grouped, *arrays, unique_queries=unique_queries)
    np.testing.assert_array_equal(got, want)
    got_lb = lower_bound_sorted_grouped(*torch_args(*arrays)).numpy()
    np.testing.assert_array_equal(got_lb, _jax(ml.lower_bound_sorted_grouped, *arrays))


def test_shared_tables_equal_per_stream_tables():
    """T tables serving S = T * R streams give what S copies of them give."""
    t_hi, t_lo, q_hi, q_lo = _streams(7, 2, 256, unique=True)
    q_hi = np.concatenate([q_hi, q_hi[::-1]])  # stream rows 0-1 on table 0, 2-3 on table 1
    q_lo = np.concatenate([q_lo, q_lo[::-1]])
    shared = lookup_sorted_grouped(*torch_args(t_hi, t_lo, q_hi, q_lo))
    copies = lookup_sorted_grouped(*torch_args(np.repeat(t_hi, 2, 0), np.repeat(t_lo, 2, 0), q_hi, q_lo))
    assert torch.equal(shared, copies)


def test_zero_width_table_misses_everything():
    q = torch.tensor([[1, 2, SENTINEL_KEY]], dtype=torch.int32)
    empty = torch.zeros((1, 0), dtype=torch.int32)
    assert torch.equal(lookup_sorted_grouped(empty, empty, q, q), torch.zeros_like(q))
    assert torch.equal(lower_bound_sorted_grouped(empty, empty, q, q), torch.zeros_like(q))

