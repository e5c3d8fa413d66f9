"""Port parity of ``ops/cuda_gather8``: the plain versions of the ``gather8``
and ``scatter8`` kernels (what a CPU tensor takes) against the JAX package's
Pallas kernels in interpret mode and against its XLA forms, and the
``autograd.Function`` that ties them together.

Tolerances:
* against interpret-mode Pallas: bit-equal, on data that is exact in bf16
  (small integers, quarter weights): the TPU kernels stage features, cotangents
  and weights in bf16, the port is f32, and on such data every sum is exact in
  either;
* ``gather8_plain`` against the XLA ``einsum`` form on f32 data: 1e-6 relative
  to ``sum_k |w8| |feats|`` (8 products summed in another order);
* ``scatter8_plain`` against ``.at[].add``: 1e-5 of the abs-sum ``sum |w8| |dy|``
  per target (a target collects up to a few hundred terms, summed in another
  order);
* gradient against ``jax.grad`` of the JAX ``gather8``: 1e-5 of the same abs-sum.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidal_tpu.ops.pallas_gather8 as pg8
from lidal_tpu_torch.ops import cuda_gather8
from lidal_tpu_torch.ops.cuda_gather8 import (
    build_transpose,
    gather8,
    gather8_forward,
    gather8_plain,
    scatter8,
    scatter8_plain,
)
from tests.test_torch_frames import torch_args

SHAPES = [
    (0, 256, 256, 32, 0.9),
    (1, 512, 256, 96, 0.5),  # sparse columns, sentinel tails
    (2, 256, 512, 128, 1.0),  # m > n: many points per voxel, as the trilinear maps
    (3, 256, 256, 8, 0.0),  # all-sentinel: exact zeros
    (4, 1024, 512, 64, 0.7),
]


def _int_rows(rng, n, c):
    return rng.integers(-4, 5, size=(n, c)).astype(np.float32)


def _quarter_weights(rng, m):
    return (rng.integers(0, 5, size=(m, 8)) / 4.0).astype(np.float32)


def _sorted_nbr(rng, m, n, density):
    """Per-column sorted maps with sentinel (== n) entries, as rulebook columns are."""
    nbr = np.full((m, 8), n, np.int32)
    cnt = int(m * density)
    for j in range(8):
        if cnt:
            rows = np.sort(rng.choice(m, size=cnt, replace=False))
            vals = np.sort(rng.choice(n, size=min(cnt, n), replace=False))
            nbr[rows[: len(vals)], j] = vals
    return nbr


def _unsorted_nbr(rng, m, n, density=0.8):
    """Random targets in no order, duplicates within a row, and all-sentinel rows."""
    nbr = rng.integers(0, n, size=(m, 8)).astype(np.int32)
    nbr[rng.random((m, 8)) > density] = n
    nbr[::7, 3] = nbr[::7, 1]  # the same target twice in one row
    nbr[5::11] = n  # rows with no real tap
    return nbr


def _xla_gather8(feats, nbr, w8):
    fx = jnp.concatenate([jnp.asarray(feats), jnp.zeros((1, feats.shape[1]), jnp.float32)])
    return np.asarray(jnp.einsum("mk,mkc->mc", jnp.asarray(w8), fx[jnp.asarray(nbr)]))


def _xla_scatter8(dy, nbr, w8, n):
    contrib = jnp.asarray(w8)[:, :, None] * jnp.asarray(dy)[:, None, :]
    return np.asarray(jnp.zeros((n, dy.shape[1]), jnp.float32).at[jnp.asarray(nbr)].add(contrib, mode="drop"))


def _abs_sum_scatter(dy, nbr, w8, n):
    return _xla_scatter8(np.abs(dy), nbr, np.abs(w8), n)


@pytest.mark.parametrize("seed,n,m,c,density", SHAPES)
def test_gather8_plain_bit_equal_to_interpret_pallas(seed, n, m, c, density):
    rng = np.random.default_rng(seed)
    feats, nbr, w8 = _int_rows(rng, n, c), _sorted_nbr(rng, m, n, density), _quarter_weights(rng, m)
    want = np.asarray(pg8.gather8_pallas(jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(w8), interpret=True))
    got = gather8_plain(*torch_args(feats, nbr, w8))
    assert got.dtype == torch.float32 and got.shape == (m, c)
    np.testing.assert_array_equal(got.numpy(), want)
    if density == 0.0:
        assert not got.any()


@pytest.mark.parametrize("sorted_columns", [True, False])
def test_gather8_plain_matches_xla_form(sorted_columns):
    rng = np.random.default_rng(7)
    n, m, c = 500, 777, 24  # no tile alignment needed off the TPU kernel
    feats = rng.standard_normal((n, c)).astype(np.float32)
    nbr = _sorted_nbr(rng, m, n, 0.8) if sorted_columns else _unsorted_nbr(rng, m, n)
    w8 = rng.random((m, 8)).astype(np.float32)
    got = gather8_forward(*torch_args(feats, nbr, w8)).numpy()  # a CPU tensor takes the plain version
    want = _xla_gather8(feats, nbr, w8)
    bound = _xla_gather8(np.abs(feats), nbr, w8)
    assert (np.abs(got - want) <= 1e-6 * bound + 1e-12).all()
    assert not got[(nbr == n).all(axis=1)].any()  # an all-sentinel row is exactly zero


def test_gather8_plain_treats_any_out_of_range_index_as_sentinel():
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((64, 4)).astype(np.float32)
    nbr = rng.integers(0, 64, size=(32, 8)).astype(np.int32)
    w8 = rng.random((32, 8)).astype(np.float32)
    odd = nbr.copy()
    odd[::2, 0], odd[1::2, 5] = -1, 1000
    clean = np.where((odd >= 0) & (odd < 64), odd, 64).astype(np.int32)
    np.testing.assert_array_equal(
        gather8_plain(*torch_args(feats, odd, w8)).numpy(), gather8_plain(*torch_args(feats, clean, w8)).numpy()
    )
    np.testing.assert_array_equal(
        scatter8_plain(*torch_args(feats[:32], odd, w8), 64).numpy(),
        scatter8_plain(*torch_args(feats[:32], clean, w8), 64).numpy(),
    )


@pytest.mark.parametrize("seed,n,m,c,density", SHAPES + [(5, 256, 1024, 16, 0.3)])
def test_scatter8_plain_bit_equal_to_interpret_pallas(seed, n, m, c, density):
    rng = np.random.default_rng(seed)
    dy, nbr, w8 = _int_rows(rng, m, c), _sorted_nbr(rng, m, n, density), _quarter_weights(rng, m)
    want = np.asarray(pg8.scatter8_pallas(jnp.asarray(dy), jnp.asarray(nbr), jnp.asarray(w8), n, interpret=True))
    got = scatter8_plain(*torch_args(dy, nbr, w8), n)
    assert got.dtype == torch.float32 and got.shape == (n, c)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sorted_columns", [True, False])
def test_scatter8_plain_matches_xla_scatter_add(sorted_columns):
    rng = np.random.default_rng(9)
    n, m, c = 60, 900, 20  # heavy fan-in: 120 pairs a target on average
    dy = rng.standard_normal((m, c)).astype(np.float32)
    nbr = _sorted_nbr(rng, m, n, 0.8) if sorted_columns else _unsorted_nbr(rng, m, n)
    w8 = rng.random((m, 8)).astype(np.float32)
    got = scatter8(*torch_args(dy, nbr, w8), n).numpy()
    want = _xla_scatter8(dy, nbr, w8, n)
    assert (np.abs(got - want) <= 1e-5 * _abs_sum_scatter(dy, nbr, w8, n) + 1e-12).all()


def test_build_transpose_lists_every_real_pair_in_ascending_order():
    rng = np.random.default_rng(10)
    n, m = 40, 300
    nbr = _unsorted_nbr(rng, m, n)
    order, offsets = build_transpose(torch.from_numpy(nbr), n)
    order, offsets = order.numpy(), offsets.numpy()
    assert order.dtype == np.int32 and offsets.dtype == np.int32 and offsets.shape == (n + 1,)
    assert offsets[0] == 0 and offsets[-1] == int((nbr < n).sum())
    flat = nbr.reshape(-1)
    for t in range(n):
        seg = order[offsets[t] : offsets[t + 1]]
        np.testing.assert_array_equal(seg, np.flatnonzero(flat == t))  # ascending i * 8 + k
    # the kernel's arithmetic, written with the transpose: same sums as the plain version
    dy = rng.standard_normal((m, 6)).astype(np.float32)
    w8 = rng.random((m, 8)).astype(np.float32)
    want = scatter8_plain(*torch_args(dy, nbr, w8), n).numpy()
    got = np.stack([
        (w8.reshape(-1)[order[offsets[t] : offsets[t + 1]], None] * dy[order[offsets[t] : offsets[t + 1]] >> 3]).sum(0)
        for t in range(n)
    ])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gather8_gradient_matches_jax(monkeypatch):
    monkeypatch.setattr(pg8, "gather8_pallas", functools.partial(pg8.gather8_pallas, interpret=True))
    rng = np.random.default_rng(11)
    n, m, c = 256, 512, 32
    feats = rng.standard_normal((n, c)).astype(np.float32)
    nbr = _sorted_nbr(rng, m, n, 0.8)
    w8 = rng.random((m, 8)).astype(np.float32)
    cot = rng.standard_normal((m, c)).astype(np.float32)
    want = np.asarray(
        jax.grad(lambda f: (pg8.gather8(f, jnp.asarray(nbr), jnp.asarray(w8)) * jnp.asarray(cot)).sum())(
            jnp.asarray(feats)
        )
    )

    f_t, nbr_t, w_t, cot_t = torch_args(feats, nbr, w8, cot)
    f_t.requires_grad_(True)
    w_t.requires_grad_(True)
    (gather8(f_t, nbr_t, w_t) * cot_t).sum().backward()
    assert w_t.grad is None  # the weights are plan data
    assert (np.abs(f_t.grad.numpy() - want) <= 1e-5 * _abs_sum_scatter(cot, nbr, w8, n) + 1e-12).all()


def test_gather8_gradcheck_f64():
    rng = np.random.default_rng(12)
    n, m, c = 9, 14, 3
    feats = torch.from_numpy(rng.standard_normal((n, c))).requires_grad_(True)
    nbr = torch.from_numpy(_unsorted_nbr(rng, m, n))
    w8 = torch.from_numpy(rng.random((m, 8)).astype(np.float32))
    assert torch.autograd.gradcheck(lambda f: gather8(f, nbr, w8), (feats,), eps=1e-6, atol=1e-6)


def test_cpu_tensors_launch_no_kernel():
    before = cuda_gather8.GATHER8_LAUNCHES, cuda_gather8.SCATTER8_LAUNCHES
    rng = np.random.default_rng(13)
    f = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32)).requires_grad_(True)
    nbr = torch.from_numpy(rng.integers(0, 17, size=(8, 8)).astype(np.int32))
    gather8(f, nbr, torch.ones(8, 8)).sum().backward()
    assert (cuda_gather8.GATHER8_LAUNCHES, cuda_gather8.SCATTER8_LAUNCHES) == before
    with pytest.raises(ValueError):
        gather8_forward(f.detach(), nbr[:, :4], torch.ones(8, 4))
