"""Shared inputs for the port's tests (``tests/test_torch_*.py``), and the
port's ``pad_points`` against the JAX package's.  The module imports no JAX,
so the on-card tests (``test_torch_cuda.py``) can use it.

Frames are surface-like (ground rings + walls, as LiDAR sweeps are), made
with numpy from a seed; the JAX function and its port get the same arrays.
"""

import numpy as np
import pytest
import torch

from lidal_tpu_torch.data.pipeline import pad_points

# Capacities small enough for CPU tests; the coarse caps overflow on these frames.
OVERFLOW_CAPS = (1024, 512, 256, 128, 64)
LOSSLESS_CAPS = (1024, 1024, 1024, 1024, 1024)


def surface_frames(seed: int, b: int = 2, p: int = 1024, n: int = 900, span: float = 6.0):
    """numpy (xyz [b, p, 3] f32, sig [b, p] f32, valid [b, p] bool, labels [b, p] int32)."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((b, p, 3), np.float32)
    sig = np.zeros((b, p), np.float32)
    valid = np.zeros((b, p), bool)
    labels = np.full((b, p), 255, np.int32)
    for i in range(b):
        k = n - 37 * i
        n_g = int(k * 0.6)
        r = 0.5 + span * rng.random(n_g) ** 1.5
        th = rng.uniform(0, 2 * np.pi, n_g)
        ground = np.stack([r * np.cos(th), r * np.sin(th), 0.05 * rng.standard_normal(n_g)], 1)
        cx, cy = rng.uniform(-span, span, (2, 4))
        wi = rng.integers(0, 4, k - n_g)
        walls = np.stack(
            [cx[wi] + rng.normal(scale=0.3, size=k - n_g), cy[wi] + rng.normal(scale=0.3, size=k - n_g),
             rng.uniform(0, 1.5, k - n_g)], 1,
        )
        xyz[i, :k] = np.concatenate([ground, walls])
        sig[i, :k] = rng.random(k)
        valid[i, :k] = True
        labels[i, :k] = rng.integers(0, 19, k)
    return xyz, sig, valid, labels


def torch_args(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("n,cap", [(700, 1024), (1024, 1024), (1500, 1024)])
def test_pad_points_matches_jax(n, cap):
    from lidal_tpu.data.pipeline import pad_points as jax_pad_points  # keeps this module jax-free

    rng = np.random.default_rng(n)
    xyz = rng.standard_normal((n, 3)).astype(np.float32)
    sig = rng.random(n).astype(np.float32)
    labels = rng.integers(0, 19, n).astype(np.int32)
    for got, want in zip(pad_points(xyz, sig, labels, cap), jax_pad_points(xyz, sig, labels, cap)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    got = pad_points(xyz, sig, None, cap)[3]
    np.testing.assert_array_equal(got, np.full(cap, 255, np.int32))
