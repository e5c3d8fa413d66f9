"""Port parity: the five-level plan (``lidal_tpu_torch/ops/kernel_map.py``) is
bit-equal to ``lidal_tpu.ops.kernel_map.build_unet_plan`` field by field, with
lossless caps and with caps that overflow at the coarse levels."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lidal_tpu.data.augment import augment_and_voxelize as jax_augment_and_voxelize
from lidal_tpu.ops import kernel_map as jkm
from lidal_tpu_torch.data.augment import augment_and_voxelize
from lidal_tpu_torch.ops import kernel_map as km
from tests.test_torch_frames import LOSSLESS_CAPS, OVERFLOW_CAPS, surface_frames, torch_args


@partial(jax.jit, static_argnames=("caps",))
def _jax_plan(xyz, sig, valid, caps):
    vf = jax.vmap(
        lambda x, s, v: jax_augment_and_voxelize(jax.random.PRNGKey(0), x, s, v, caps[0], augment=False)
    )(xyz, sig, valid)
    return jkm.build_unet_plan(vf.uv.coords, vf.uv.valid, caps)


def test_offsets_match_jax():
    assert km.OFFSETS3 == jkm.OFFSETS3 and km.OFFSETS2 == jkm.OFFSETS2
    assert (km.K3, km.CENTER3, km.K2) == (jkm.K3, jkm.CENTER3, jkm.K2)


@pytest.mark.parametrize("caps,span", [(LOSSLESS_CAPS, 6.0), (OVERFLOW_CAPS, 6.0), (OVERFLOW_CAPS, 40.0)])
def test_build_unet_plan_bit_equal(caps, span):
    xyz, sig, valid, _ = surface_frames(11, b=2, p=1024, n=1000, span=span)
    vf = augment_and_voxelize(None, *torch_args(xyz, sig, valid), caps[0], augment=False)
    got = km.build_unet_plan(vf.uv.coords, vf.uv.valid, caps)
    want = _jax_plan(jnp.asarray(xyz), jnp.asarray(sig), jnp.asarray(valid), caps)
    assert len(got.levels) == len(want.levels) == len(caps)
    for lvl, (g, w) in enumerate(zip(got.levels, want.levels)):
        for name in w._fields:
            np.testing.assert_array_equal(
                getattr(g, name).numpy(), np.asarray(getattr(w, name)), err_msg=f"level {lvl} {name}"
            )
    for lvl, (g, w) in enumerate(zip(got.downs, want.downs)):
        for name in w._fields:
            np.testing.assert_array_equal(
                getattr(g, name).numpy(), np.asarray(getattr(w, name)), err_msg=f"down {lvl} {name}"
            )
    overflow = sum(int(lv.overflow.sum()) for lv in got.levels)
    assert (overflow > 0) == (caps == OVERFLOW_CAPS)
    # every level has real neighbours beyond the centre tap
    for lv in got.levels:
        nb = lv.nbr3.numpy()
        assert (nb[..., : km.CENTER3] < nb.shape[1]).any()


def test_rulebook_streams_stay_sorted():
    xyz, sig, valid, _ = surface_frames(12, b=2)
    vf = augment_and_voxelize(None, *torch_args(xyz, sig, valid), 1024, augment=False)
    t_hi, t_lo, q_hi, q_lo = km.rulebook_streams(vf.uv.coords, vf.uv.valid)
    assert t_hi.shape == (2, 1024) and q_hi.shape == (2 * 26, 1024)
    key = (q_hi.long() << 32) + q_lo.long()
    assert bool((key[:, 1:] >= key[:, :-1]).all())


def test_up_map_parents_are_not_monotonic():
    """``lidal_tpu/ops/conv.py:73-75`` says ``parent`` is non-decreasing, so the
    up conv's per-tap columns stay sorted.  It is not (x-major order of fine
    voxels is not x-major order of their parents); the conv kernels of both
    packages index any order, so no value depends on it."""
    xyz, sig, valid, _ = surface_frames(13, b=1, n=1000)
    vf = augment_and_voxelize(None, *torch_args(xyz, sig, valid), 1024, augment=False)
    plan = km.build_unet_plan(vf.uv.coords, vf.uv.valid, LOSSLESS_CAPS)
    parent = plan.downs[0].parent[0]
    real = parent < LOSSLESS_CAPS[1]
    steps = parent[1:][real[1:]] - parent[:-1][real[1:]]
    assert int((steps < 0).sum()) > 0
