"""The bf16 route of ``ops/cuda_gather8`` on f32 tables, and the child-sum
chain (``child_sum``), against the JAX package and against the order the
CUDA kernels sum in.

The route's kernels read f32 rows and round each value to bf16 in registers;
their plain versions round the f32 operands with a cast.  Here the plain
versions, given f32 tables, are held against the JAX package's Pallas kernels
in interpret mode, which cast their f32 inputs themselves:

* ``gather8`` and ``scatter8``: bit-equal on data whose values round to small
  integers in bf16 (64-71 plus a fraction, exact ties to even among them;
  weights near quarters): the products and sums of the rounded values are
  exact in f32, so any order gives the same bits, and the f32 versions
  differ (the rounding is there);
* ``scatter8`` on normal data: 1e-5 of the abs-sum ``sum |w8| |dy|``
  (sums of exact products in another order).

The chain: ``child_sum_plain`` (one ``gather8_plain`` a level) is bit-equal,
sign of zero included, to a numpy emulation of the CUDA kernel's depth-first
walk (per row of the last level, its subtree summed level by level, children
in ascending order, a sentinel child adding +0, each add rounded on its own,
each child rounded to bf16 on the route), and to the JAX package's
``point_to_voxel_avg_batched`` under ``conv.USE_PALLAS`` (Pallas in interpret
mode) on data whose level sums are exact.  The fused backward (one row gather
through the ancestors) is bit-equal to the chained ``parent`` gathers it
replaces.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidal_tpu.ops.conv as jconv
import lidal_tpu.ops.pallas_gather8 as pg8
from lidal_tpu.data.pipeline import prepare_eval_batch as jax_prepare_eval_batch
from lidal_tpu.ops import devoxelize as jdev
from lidal_tpu_torch.data.pipeline import prepare_eval_batch
from lidal_tpu_torch.ops import conv
from lidal_tpu_torch.ops.conv import _flatten_idx
from lidal_tpu_torch.ops.cuda_gather8 import child_sum, child_sum_plain, gather8_plain, scatter8_plain
from lidal_tpu_torch.ops.devoxelize import point_to_voxel_avg_batched
from lidal_tpu_torch.utils import profiling
from tests.test_torch_frames import surface_frames, torch_args
from tests.test_torch_gather8 import _sorted_nbr

MODEL_CAPS = (512, 256, 128, 128, 128)  # B = 2: every level's rows a multiple of 256 (Pallas tiles)


def _bits(t) -> np.ndarray:
    a = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(torch.bfloat16).float().numpy()


def _near_int_rows(rng, n, c):
    """Values 64-71 of either sign plus a fraction that bf16 rounds away
    (spacing 0.5 there), a tenth of them exact ties (x.25 / x.75 round to
    even): the rounded values are small integers and halves."""
    base = rng.integers(64, 72, size=(n, c)) * rng.choice([-1.0, 1.0], size=(n, c))
    frac = rng.uniform(-0.24, 0.24, size=(n, c))
    ties = rng.random((n, c)) < 0.1
    frac[ties] = rng.choice([-0.25, 0.25], size=int(ties.sum()))
    x = (base + frac).astype(np.float32)
    assert not np.array_equal(_bf16(x), x)
    return x


def _near_quarter_weights(rng, m):
    """Quarters 0-1 plus a perturbation that bf16 rounds away (w8 of the
    route's scatter8 is rounded)."""
    w = rng.integers(0, 5, size=(m, 8)) / 4.0
    w = w + np.where(w > 0, rng.uniform(-4e-4, 4e-4, size=(m, 8)), 0.0)
    return w.astype(np.float32)


@pytest.mark.parametrize("seed,n,m,c,density", [(80, 256, 512, 32, 0.8), (81, 512, 256, 64, 0.5), (82, 256, 768, 16, 1.0)])
def test_route_gather8_plain_on_an_f32_table_bit_equal_to_interpret_pallas(seed, n, m, c, density):
    rng = np.random.default_rng(seed)
    feats, nbr = _near_int_rows(rng, n, c), _sorted_nbr(rng, m, n, density)
    w8 = (rng.integers(0, 5, size=(m, 8)) / 4.0).astype(np.float32)  # gather8 keeps w8 in f32
    want = np.asarray(pg8.gather8_pallas(jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(w8), interpret=True))
    got = gather8_plain(*torch_args(feats, nbr, w8), True)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not np.array_equal(gather8_plain(*torch_args(feats, nbr, w8)).numpy(), got.numpy())


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("seed,n,m,c,density", [(83, 256, 512, 32, 0.8), (84, 512, 256, 64, 0.5)])
def test_route_scatter8_plain_on_f32_dy_matches_interpret_pallas(seed, n, m, c, density, integer):
    rng = np.random.default_rng(seed)
    nbr = _sorted_nbr(rng, m, n, density)
    if integer:
        dy, w8 = _near_int_rows(rng, m, c), _near_quarter_weights(rng, m)
    else:
        dy, w8 = rng.standard_normal((m, c)).astype(np.float32), rng.random((m, 8)).astype(np.float32)
    want = np.asarray(pg8.scatter8_pallas(jnp.asarray(dy), jnp.asarray(nbr), jnp.asarray(w8), n, interpret=True))
    got = scatter8_plain(*torch_args(dy, nbr, w8), n, True).numpy()
    if integer:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        abs_sum = scatter8_plain(*torch_args(np.abs(dy), nbr, w8), n, True).numpy()
        assert (np.abs(got - want) <= 1e-5 * abs_sum).all(), float(np.abs(got - want).max())
    assert not np.array_equal(scatter8_plain(*torch_args(dy, nbr, w8), n).numpy(), got)


# ---- the child-sum chain ---------------------------------------------------------------------------


def _kernel_order_chain(x, children, counts, bf16):
    """numpy float32 emulation of ``csrc/gather8.cu:child_sum_kernel``: a walk
    per row of the last level, depth first (``node_sum``), then the divide."""
    rnd = _bf16 if bf16 else (lambda a: a)
    caps = [x.shape[1]] + [ch.shape[1] for ch in children]
    c = x.shape[2]
    zero = np.zeros(c, np.float32)

    def node(b, d, row):  # the sum at level d >= 1
        acc = np.zeros(c, np.float32)
        for k in range(8):
            j = int(children[d - 1][b, row, k])
            if 0 <= j < caps[d - 1]:
                v = rnd(x[b, j]) if d == 1 else rnd(node(b, d - 1, j))
            else:
                v = zero
            acc = np.add(acc, v, dtype=np.float32)
        return acc

    L = len(children)
    sums = np.stack([np.stack([node(b, L, o) for o in range(caps[L])]) for b in range(x.shape[0])])
    return (sums / np.maximum(counts, 1).astype(np.float32)[..., None]).astype(np.float32)


def _random_chain(rng, levels, c, b=2):
    """Random maps with sentinels, out-of-range and negative children, a row
    reached twice, and points that include -0.0 and +0.0 rows and values."""
    caps = [int(rng.integers(40, 90))]
    for _ in range(levels):
        caps.append(max(3, caps[-1] // int(rng.integers(2, 4))))
    children = []
    for l in range(levels):
        ch = rng.integers(0, caps[l], size=(b, caps[l + 1], 8)).astype(np.int32)
        ch[rng.random(ch.shape) > 0.6] = caps[l]
        ch[:, ::5] = caps[l]  # rows with no child
        ch[0, 1, 2], ch[1, 2, 3] = -1, caps[l] + 7
        children.append(ch)
    x = rng.standard_normal((b, caps[0], c)).astype(np.float32)
    x[:, ::4] = -0.0
    x[:, 1::7] = 0.0
    x[rng.random(x.shape) < 0.2] = -0.0
    counts = rng.integers(0, 5, size=(b, caps[-1])).astype(np.int32)
    return x, children, counts


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("levels,c", [(1, 4), (2, 12), (3, 8), (4, 16)])
def test_child_sum_plain_bit_equal_to_the_kernels_order(levels, c, bf16):
    rng = np.random.default_rng(90 + levels + 10 * bf16)
    x, children, counts = _random_chain(rng, levels, c)
    got = child_sum_plain(torch.from_numpy(x), [torch.from_numpy(ch) for ch in children], torch.from_numpy(counts), bf16)
    assert got.dtype == torch.float32 and got.shape == (2, children[-1].shape[1], c)
    want = _kernel_order_chain(x, children, counts, bf16)
    np.testing.assert_array_equal(_bits(got), _bits(want))  # sign of zero included
    # a CPU tensor takes the plain version through the wrapper
    assert torch.equal(child_sum(torch.from_numpy(x), [torch.from_numpy(ch) for ch in children],
                                 torch.from_numpy(counts), bf16), got)


@pytest.fixture(scope="module")
def plans():
    xyz, sig, valid, _ = surface_frames(91, b=2, p=512, n=480)
    eb_j = jax_prepare_eval_batch(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(xyz), jnp.asarray(sig), jnp.asarray(valid),
        level_caps=MODEL_CAPS, with_points=True, augment=False,
    )
    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=MODEL_CAPS, augment=False, with_points=True)
    return eb, eb_j


@contextlib.contextmanager
def _jax_route():
    with mock.patch.object(jconv, "USE_PALLAS", True), mock.patch.object(
        pg8, "gather8_pallas", functools.partial(pg8.gather8_pallas, interpret=True)
    ):
        yield


@pytest.mark.parametrize("name,levels", [("avg2", 2), ("avg4", 4)])
def test_child_sum_on_the_route_bit_equal_to_the_jax_pallas_chain(plans, name, levels):
    """Each level's sums are exact (sums of small integers and halves, then
    rounded to bf16 before the next level), so the JAX chain's band order and
    the port's ascending order give the same bits."""
    eb, eb_j = plans
    rng = np.random.default_rng(100 + levels)
    x = _near_int_rows(rng, 2 * MODEL_CAPS[0], 8).reshape(2, MODEL_CAPS[0], 8)
    x *= eb.plan.levels[0].valid.numpy()[..., None]  # invalid rows must be zero
    with _jax_route():
        want = np.asarray(jdev.point_to_voxel_avg_batched(jnp.asarray(x), eb_j.plan.downs, getattr(eb_j.pplan, name),
                                                          levels=levels))
    with mock.patch.object(conv, "BF16_OPERANDS", True):
        got = point_to_voxel_avg_batched(torch.from_numpy(x), eb.plan.downs, getattr(eb.pplan, name), levels)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (got != 0).any()
    f32 = point_to_voxel_avg_batched(torch.from_numpy(x), eb.plan.downs, getattr(eb.pplan, name), levels)
    assert not torch.equal(f32, got)  # the route rounded the points and the levels


def _chained_parent_backward(dy, downs, counts, levels):
    """The backward the chain had: autograd's gradient of the divide, then a
    copy through each level's ``parent``, zero where it is the sentinel."""
    g = dy / counts.clamp_min(1).to(dy.dtype)[..., None]
    for l in reversed(range(levels)):
        parent = downs[l].parent
        b, cap_c, c = g.shape
        idx = _flatten_idx(parent, cap_c).long()
        real = idx < b * cap_c
        g = g.reshape(b * cap_c, c).index_select(0, idx.clamp_max(max(b * cap_c - 1, 0)))
        g.masked_fill_(~real[:, None], 0.0)
        g = g.reshape(b, parent.shape[1], c)
    return g


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name,levels", [("avg2", 2), ("avg4", 4)])
def test_fused_backward_bit_equal_to_the_chained_parent_gathers(plans, name, levels, bf16):
    eb, _ = plans
    rng = np.random.default_rng(110 + levels)
    avg = getattr(eb.pplan, name)
    x = rng.standard_normal((2, MODEL_CAPS[0], 12)).astype(np.float32) * eb.plan.levels[0].valid.numpy()[..., None]
    dy = rng.standard_normal((2, MODEL_CAPS[levels], 12)).astype(np.float32)
    dy[:, ::3] = -0.0
    x_t = torch.from_numpy(x).requires_grad_(True)
    with mock.patch.object(conv, "BF16_OPERANDS", bf16):
        out = point_to_voxel_avg_batched(x_t, eb.plan.downs, avg, levels)
    out.backward(torch.from_numpy(dy))
    want = _chained_parent_backward(torch.from_numpy(dy), eb.plan.downs, avg.counts, levels)
    np.testing.assert_array_equal(_bits(x_t.grad), _bits(want))
    assert (x_t.grad != 0).any() and not x_t.grad[~eb.plan.levels[0].valid].any()


def test_child_sum_counts_its_launches_only_on_a_card():
    before = profiling.counter("launch.child_sum"), profiling.counter("launch.child_sum_bf16")
    rng = np.random.default_rng(120)
    x, children, counts = _random_chain(rng, 2, 4)
    child_sum(torch.from_numpy(x), [torch.from_numpy(ch) for ch in children], torch.from_numpy(counts), True)
    assert (profiling.counter("launch.child_sum"), profiling.counter("launch.child_sum_bf16")) == before
