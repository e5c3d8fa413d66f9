"""Port parity: keys, voxel dedup and augment+voxelize are bit-equal to the JAX
package on every field (``lidal_tpu_torch/ops/{hashing,voxelize}.py``,
``lidal_tpu_torch/data/augment.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.data.augment import augment_and_voxelize as jax_augment_and_voxelize
from lidal_tpu.ops import hashing as jh
from lidal_tpu.ops import voxelize as jv
from lidal_tpu_torch.data.augment import augment_and_voxelize
from lidal_tpu_torch.ops.hashing import SENTINEL_KEY, pack_keys, sort_with_keys
from lidal_tpu_torch.ops.voxelize import append_zero_row, devoxelize_nearest, unique_voxels
from tests.test_torch_frames import surface_frames, torch_args


def _coords(rng, n, lo=0, hi=40, dup_frac=0.5):
    c = rng.integers(lo, hi, size=(n, 3)).astype(np.int32)
    dup = rng.random(n) < dup_frac
    c[dup] = c[rng.integers(0, n, dup.sum())]
    return c


def _assert_fields_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def test_sentinel_matches_jax():
    assert SENTINEL_KEY == int(jh.SENTINEL_KEY)


def test_pack_keys_bit_equal_at_packing_bounds():
    rng = np.random.default_rng(0)
    c = _coords(rng, 500, lo=-1, hi=16383)
    c[:4] = [[16382, 16382, 5], [-1, -1, -1], [0, 16382, 2**31 - 3], [16382, -1, 0]]
    v = rng.random(500) < 0.8
    got = pack_keys(*torch_args(c, v))
    want = jh.pack_keys(jnp.asarray(c), jnp.asarray(v))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sort_with_keys_is_stable_lexicographic():
    rng = np.random.default_rng(1)
    hi = rng.integers(-3, 3, 400).astype(np.int32)
    lo = rng.integers(-(2**31), 2**31 - 1, 400, dtype=np.int64).astype(np.int32)
    lo[::3] = lo[0]
    hi[::3] = hi[0]
    idx = np.arange(400, dtype=np.int32)
    got = sort_with_keys(*torch_args(hi, lo, idx))
    want = jh.sort_with_keys(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize(
    "case,n,cap",
    [
        ("dense", 600, 1024),
        ("overflow", 600, 100),  # num_unique > cap_out
        ("exact", 256, 256),
        ("all_invalid", 300, 128),
        ("bounds", 400, 512),
    ],
)
def test_unique_voxels_bit_equal(case, n, cap):
    rng = np.random.default_rng(n + cap)
    c = _coords(rng, n)
    v = rng.random(n) < 0.85
    if case == "all_invalid":
        v[:] = False
    if case == "bounds":
        c = _coords(rng, n, lo=-1, hi=16383)
        c[:3] = [[16382, 16382, 16382], [-1, -1, -1], [16382, 0, -1]]
        v[:3] = True
    got = unique_voxels(*torch_args(c, v), cap)
    want = jv.unique_voxels(jnp.asarray(c), jnp.asarray(v), cap)
    _assert_fields_equal(got, want)


def test_unique_voxels_batch_equals_per_frame():
    rng = np.random.default_rng(3)
    c = np.stack([_coords(rng, 500) for _ in range(3)])
    v = rng.random((3, 500)) < 0.9
    v[2] = False
    batched = unique_voxels(*torch_args(c, v), 200)
    for b in range(3):
        _assert_fields_equal([f[b] for f in batched], unique_voxels(*torch_args(c[b], v[b]), 200))


def test_devoxelize_nearest_and_zero_row_match_jax():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 50, 3)).astype(np.float32)
    inverse = rng.integers(0, 51, (2, 80)).astype(np.int32)  # 50 = the sentinel slot
    got = devoxelize_nearest(append_zero_row(torch.from_numpy(feats)), torch.from_numpy(inverse))
    for b in range(2):
        want = jv.devoxelize_nearest(jv.append_zero_row(jnp.asarray(feats[b])), jnp.asarray(inverse[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("cap0,all_invalid", [(1024, False), (300, False), (512, True)])
def test_augment_and_voxelize_bit_equal_without_augmentation(cap0, all_invalid):
    xyz, sig, valid, _ = surface_frames(5, b=2, p=1024, n=900)
    if all_invalid:
        valid[1] = False
    got = augment_and_voxelize(None, *torch_args(xyz, sig, valid), cap0, augment=False)
    fn = jax.vmap(lambda x, s, v: jax_augment_and_voxelize(jax.random.PRNGKey(0), x, s, v, cap0, augment=False))
    want = fn(jnp.asarray(xyz), jnp.asarray(sig), jnp.asarray(valid))
    _assert_fields_equal(got.uv, want.uv)
    np.testing.assert_array_equal(got.feats.numpy(), np.asarray(want.feats))
    np.testing.assert_array_equal(got.point_valid.numpy(), np.asarray(want.point_valid))
    if cap0 == 300:
        assert int(got.uv.num_unique.min()) > cap0  # the overflow branch really ran


def test_augment_draws_come_from_the_generator():
    xyz, sig, valid, _ = surface_frames(6, b=2)
    args = torch_args(xyz, sig, valid)
    a = augment_and_voxelize(torch.Generator().manual_seed(3), *args, 1024)
    b = augment_and_voxelize(torch.Generator().manual_seed(3), *args, 1024)
    c = augment_and_voxelize(torch.Generator().manual_seed(4), *args, 1024)
    for x, y in zip(a.uv, b.uv):
        assert torch.equal(x, y)
    assert not torch.equal(a.feats, c.feats)
    # intensity is not augmented, and every kept voxel lies in the grid
    kept = a.uv.valid
    src_sig = torch.from_numpy(sig).gather(1, a.uv.first_src.long())
    assert torch.equal(a.feats[..., 3][kept], src_sig[kept])
    assert int(a.uv.coords[kept].min()) >= 0 and int(a.uv.coords[kept].max()) < 8192
    assert torch.equal(a.point_valid, torch.from_numpy(valid) & (a.uv.inverse < 1024))
