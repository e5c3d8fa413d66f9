"""Port parity of ``ops/devoxelize``: the SPVCNN point plan and the
point<->voxel transfers against the JAX package, from the same frames.

* every integer field of the ``PointPlan`` (``idx8``, ``anc``, ``counts``) is
  bit-equal and ``w8`` is equal (products of dyadic fractions, exact in f32),
  with lossless caps, with caps that overflow at every coarse level, and with
  an empty frame in the batch;
* the batched trilinear devoxelize and the point->voxel average against the JAX
  functions (off the TPU: the XLA gather + ``einsum`` and the scatter-add):
  rtol = atol = 1e-5 (8 products, or up to a few hundred points of a voxel,
  summed in another order), and the same for their gradients;
* the port's average is the child-sum chain on every device; it must equal the
  scatter form, forward and gradient, with overflowing caps too: a voxel
  dropped at a level cap drops its whole subtree from both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.data.pipeline import prepare_eval_batch as jax_prepare_eval_batch
from lidal_tpu.ops import devoxelize as jdev
from lidal_tpu.ops.batching import map_frames
from lidal_tpu.ops.voxelize import voxelize_mean as jax_voxelize_mean
from lidal_tpu_torch.data.pipeline import prepare_eval_batch
from lidal_tpu_torch.ops.devoxelize import (
    AvgMap,
    build_point_plan_frame,
    devoxelize_trilinear,
    devoxelize_trilinear_batched,
    point_to_voxel_avg,
    point_to_voxel_avg_batched,
)
from lidal_tpu_torch.ops.voxelize import unique_voxels, voxelize_mean
from tests.test_torch_frames import LOSSLESS_CAPS, OVERFLOW_CAPS, surface_frames, torch_args

CASES = {"lossless": LOSSLESS_CAPS, "overflow": OVERFLOW_CAPS, "empty_frame": OVERFLOW_CAPS}


def _batches(case):
    xyz, sig, valid, _ = surface_frames(71, b=2, p=1024, n=900)
    if case == "empty_frame":
        valid[1] = False
    caps = CASES[case]
    eb_j = jax_prepare_eval_batch(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(xyz), jnp.asarray(sig), jnp.asarray(valid),
        level_caps=caps, with_points=True, augment=False,
    )
    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=caps, augment=False, with_points=True)
    return eb, eb_j, caps


@pytest.fixture(scope="module", params=list(CASES))
def batches(request):
    return (request.param,) + _batches(request.param)


def test_point_plan_matches_jax(batches):
    case, eb, eb_j, caps = batches
    overflow = int(eb.overflow[:, 1:].sum())
    assert (overflow > 0) == (case != "lossless")
    for name in ("tri2", "tri4"):
        tri, tri_j = getattr(eb.pplan, name), getattr(eb_j.pplan, name)
        assert tri.idx8.dtype == torch.int32 and tri.w8.dtype == torch.float32
        np.testing.assert_array_equal(tri.idx8.numpy(), np.asarray(tri_j.idx8), err_msg=name)
        np.testing.assert_array_equal(tri.w8.numpy(), np.asarray(tri_j.w8), err_msg=name)
    for name, lvl in (("avg2", 2), ("avg4", 4)):
        avg, avg_j = getattr(eb.pplan, name), getattr(eb_j.pplan, name)
        assert avg.anc.dtype == torch.int32 and avg.counts.dtype == torch.int32
        np.testing.assert_array_equal(avg.anc.numpy(), np.asarray(avg_j.anc), err_msg=name)
        np.testing.assert_array_equal(avg.counts.numpy(), np.asarray(avg_j.counts), err_msg=name)
        assert avg.counts.shape == (2, caps[lvl])
    valid0 = eb.plan.levels[0].valid
    assert not eb.pplan.tri4.w8[~valid0].any() and bool((eb.pplan.tri4.idx8[~valid0] == caps[4]).all())
    if case == "empty_frame":
        assert not eb.pplan.avg4.counts[1].any() and not eb.pplan.tri2.w8[1].any()


def test_point_plan_frame_is_the_batched_plan_of_one_frame(batches):
    _, eb, _, _ = batches
    levels = [type(lv)(*(t[1] for t in lv)) for lv in eb.plan.levels]
    downs = [type(dn)(*(t[1] for t in dn)) for dn in eb.plan.downs]
    pp = build_point_plan_frame(levels, downs)
    for got, want in zip(pp, eb.pplan):
        for g, w in zip(got, want):
            assert torch.equal(g, w[1])


def _point_feats(rng, eb, c):
    pf = rng.standard_normal(eb.feats.shape[:2] + (c,)).astype(np.float32)
    return pf * eb.plan.levels[0].valid.numpy()[..., None]  # invalid rows must be zero


@pytest.mark.parametrize("name,lvl", [("tri2", 2), ("tri4", 4)])
def test_devoxelize_trilinear_and_gradient_match_jax(batches, name, lvl):
    _, eb, eb_j, caps = batches
    rng = np.random.default_rng(lvl)
    c = 12
    vf = rng.standard_normal((2, caps[lvl], c)).astype(np.float32)
    cot = rng.standard_normal((2, caps[0], c)).astype(np.float32)
    tri_j = getattr(eb_j.pplan, name)

    def f_j(v):
        return jdev.devoxelize_trilinear_batched(v, tri_j)

    want = np.asarray(f_j(jnp.asarray(vf)))
    want_g = np.asarray(jax.grad(lambda v: (f_j(v) * jnp.asarray(cot)).sum())(jnp.asarray(vf)))

    v_t = torch.from_numpy(vf).requires_grad_(True)
    out = devoxelize_trilinear_batched(v_t, getattr(eb.pplan, name))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v_t.grad.numpy(), want_g, rtol=1e-5, atol=1e-5)
    assert not out.detach()[~eb.plan.levels[0].valid].any()
    # one frame through the unbatched entry
    tri = getattr(eb.pplan, name)
    one = devoxelize_trilinear(torch.from_numpy(vf[0]), type(tri)(tri.idx8[0], tri.w8[0]))
    assert torch.equal(one, out.detach()[0])


@pytest.mark.parametrize("name,lvl", [("avg2", 2), ("avg4", 4)])
def test_point_to_voxel_chain_and_gradient_match_jax_and_the_scatter_form(batches, name, lvl):
    _, eb, eb_j, caps = batches
    rng = np.random.default_rng(10 + lvl)
    c = 12
    pf = _point_feats(rng, eb, c)
    cot = rng.standard_normal((2, caps[lvl], c)).astype(np.float32)
    avg_j = getattr(eb_j.pplan, name)

    def f_j(x):  # off the TPU this is the per-frame scatter-add
        return jdev.point_to_voxel_avg_batched(x, eb_j.plan.downs, avg_j, levels=lvl)

    want = np.asarray(f_j(jnp.asarray(pf)))
    want_g = np.asarray(jax.grad(lambda x: (f_j(x) * jnp.asarray(cot)).sum())(jnp.asarray(pf)))

    avg = getattr(eb.pplan, name)
    x_t = torch.from_numpy(pf).requires_grad_(True)
    out = point_to_voxel_avg_batched(x_t, eb.plan.downs, avg, levels=lvl)  # the child-sum chain
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x_t.grad.numpy(), want_g, rtol=1e-5, atol=1e-5)
    assert not out.detach()[avg.counts == 0].any()  # counts == 0 divides by 1

    # the port's own scatter form, frame by frame, forward and gradient
    x_s = torch.from_numpy(pf).requires_grad_(True)
    out_s = torch.stack([point_to_voxel_avg(x_s[b], AvgMap(avg.anc[b], avg.counts[b])) for b in range(2)])
    (out_s * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_s.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x_t.grad.numpy(), x_s.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_jax_scatter_form_is_what_the_tests_compare_with():
    """Guards the comparison above: off the TPU the JAX batched average is the
    per-frame scatter form (``map_frames(point_to_voxel_avg)``)."""
    eb, eb_j, caps = _batches("overflow")
    pf = jnp.asarray(_point_feats(np.random.default_rng(0), eb, 4))
    a = jdev.point_to_voxel_avg_batched(pf, eb_j.plan.downs, eb_j.pplan.avg4, levels=4)
    b = map_frames(jdev.point_to_voxel_avg, pf, eb_j.pplan.avg4)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("cap_out", [64, 400])
def test_voxelize_mean_matches_jax(cap_out):
    rng = np.random.default_rng(cap_out)
    n = 500
    coords = rng.integers(0, 6, size=(n, 3)).astype(np.int32)  # up to 216 voxels: cap 64 overflows
    valid = rng.random(n) < 0.9
    feats = rng.standard_normal((n, 5)).astype(np.float32)
    uv = unique_voxels(*torch_args(coords, valid), cap_out)
    got = voxelize_mean(torch.from_numpy(feats), uv.inverse, uv.counts)
    want = jax_voxelize_mean(jnp.asarray(feats), jnp.asarray(uv.inverse.numpy()), jnp.asarray(uv.counts.numpy()))
    assert got.shape == (cap_out, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert not got[uv.counts == 0].any()
    v = int(np.flatnonzero(uv.counts.numpy() > 1)[0])
    np.testing.assert_allclose(got[v].numpy(), feats[uv.inverse.numpy() == v].mean(0), rtol=1e-5, atol=1e-6)
