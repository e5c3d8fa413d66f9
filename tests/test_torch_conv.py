"""Port parity: the fused conv + eval-BN ops (``lidal_tpu_torch/ops/conv.py``,
kernel wrapper ``ops/cuda_conv.py``) against the JAX package.

* vs JAX ``*_conv_bn_batched`` on its XLA path, random f32 data: rtol = atol =
  1e-5 (f32 sums of up to 27 * 384 products, taken in another order);
* vs ``subm_conv_pallas(..., interpret=True)``: bit-exact, with small integer
  features and weights and dyadic scale/shift, which are exact in the TPU
  kernel's bf16 staging and in every f32 sum.

On the CPU the wrapper runs its plain version; ``test_torch_cuda.py`` holds
the CUDA kernel against it on the card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidal_tpu.ops.conv as jconv
import lidal_tpu.ops.pallas_conv as pconv
from lidal_tpu_torch.data.augment import augment_and_voxelize
from lidal_tpu_torch.ops import conv, cuda_conv
from lidal_tpu_torch.ops.kernel_map import build_unet_plan
from tests.test_torch_frames import surface_frames, torch_args

# Pallas needs m and n to be multiples of 256: B = 2 frames of these caps.
CAPS = (512, 256, 256, 256, 256)


@pytest.fixture(scope="module")
def plan():
    xyz, sig, valid, _ = surface_frames(21, b=2, p=1024, n=420, span=5.0)
    vf = augment_and_voxelize(None, *torch_args(xyz, sig, valid), CAPS[0], augment=False)
    return build_unet_plan(vf.uv.coords, vf.uv.valid, CAPS)


@pytest.fixture
def pallas_conv_on(monkeypatch):
    monkeypatch.setattr(
        pconv, "subm_conv_pallas", functools.partial(pconv.subm_conv_pallas, interpret=True)
    )
    monkeypatch.setattr(jconv, "USE_PALLAS", True)


@pytest.fixture
def xla_conv(monkeypatch):
    monkeypatch.setattr(jconv, "USE_PALLAS", False)


def _call(kind, lib, plan, x, w, scale, shift, relu):
    """One batched conv of ``kind`` through the JAX package or the port."""
    to = jnp.asarray if lib is jconv else torch.from_numpy
    d = plan.downs[0]
    # the port's convs take the map's row order from the plan; the JAX package's take none
    order = {} if lib is jconv else {"order": {"subm": plan.levels[0].order, "down": d.child_order,
                                               "up": d.up_order}[kind]}
    if kind == "subm":
        return lib.subm_conv_bn_batched(to(x), to(w), to(plan.levels[0].nbr3.numpy()), to(scale), to(shift), relu,
                                        **order)
    if kind == "down":
        return lib.down_conv_bn_batched(to(x), to(w), to(d.child.numpy()), to(scale), to(shift), relu, **order)
    return lib.up_conv_bn_batched(
        to(x), to(w), to(d.parent.numpy()), to(d.pdelta.numpy()), to(scale), to(shift), relu, **order
    )


def _inputs(rng, kind, cin, cout, integer):
    rows = CAPS[0] if kind in ("subm", "down") else CAPS[1]  # the conv's source level
    k = 27 if kind == "subm" else 8
    if integer:
        # the TPU kernel rounds each tap's product feats @ w[k] to bf16, which
        # holds integers exactly up to 256: keep cin * |x| * |w| within that
        a = 4 if cin <= 16 else 1
        x = rng.integers(-a, a + 1, (2, rows, cin)).astype(np.float32)
        w = rng.integers(-a, a + 1, (k, cin, cout)).astype(np.float32)
        scale = rng.integers(-4, 5, cout).astype(np.float32) * 0.25
        shift = rng.integers(-8, 9, cout).astype(np.float32) * 0.5
    else:
        x = rng.standard_normal((2, rows, cin)).astype(np.float32)
        w = (rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        shift = rng.normal(scale=0.1, size=cout).astype(np.float32)
    return x, w, scale, shift


SHAPES = [("subm", 4, 32), ("subm", 128, 96), ("down", 32, 64), ("up", 64, 32)]


@pytest.mark.parametrize("kind,cin,cout", SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_conv_bn_matches_jax_xla(xla_conv, plan, kind, cin, cout, relu):
    x, w, scale, shift = _inputs(np.random.default_rng(cin + cout), kind, cin, cout, integer=False)
    got = _call(kind, conv, plan, x, w, scale, shift, relu).numpy()
    want = np.asarray(_call(kind, jconv, plan, x, w, scale, shift, relu))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    out_valid = (plan.levels[1] if kind == "down" else plan.levels[0]).valid.numpy()
    assert (got != 0).any() and (got[~out_valid] == 0).all()


@pytest.mark.parametrize("kind,cin,cout", SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_conv_bn_bit_exact_vs_pallas_interpret(pallas_conv_on, plan, kind, cin, cout, relu):
    x, w, scale, shift = _inputs(np.random.default_rng(7 * cin + cout), kind, cin, cout, integer=True)
    got = _call(kind, conv, plan, x, w, scale, shift, relu).numpy()
    want = np.asarray(_call(kind, jconv, plan, x, w, scale, shift, relu))
    np.testing.assert_array_equal(got, want)


def test_flattened_maps_match_jax(plan):
    nbr = plan.levels[0].nbr3
    d = plan.downs[0]
    np.testing.assert_array_equal(
        conv._flatten_nbr(nbr, CAPS[0]).numpy(), np.asarray(jconv._flatten_nbr(jnp.asarray(nbr.numpy()), CAPS[0]))
    )
    flat_parent = conv._flatten_idx(d.parent, CAPS[1])
    np.testing.assert_array_equal(
        flat_parent.numpy(), np.asarray(jconv._flatten_idx(jnp.asarray(d.parent.numpy()), CAPS[1]))
    )
    got = conv._up_nbr(flat_parent, d.pdelta.reshape(-1), 8, 2 * CAPS[1])
    want = jconv._up_nbr(jnp.asarray(flat_parent.numpy()), jnp.asarray(d.pdelta.numpy().reshape(-1)), 8, 2 * CAPS[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_conv_without_epilogue_is_the_gather_gemm():
    """No epilogue: out = sum_k feats[nbr[:, k]] @ w[k], sentinel (and any index
    >= n) contributing zero; the im2col chunks cover every row."""
    rng = np.random.default_rng(3)
    n, m, k, cin, cout = 50, 70, 8, 12, 32
    feats = rng.standard_normal((n, cin)).astype(np.float32)
    w = rng.standard_normal((k, cin, cout)).astype(np.float32)
    nbr = rng.integers(0, n + 5, (m, k)).astype(np.int32)
    fx = np.concatenate([feats, np.zeros((1, cin), np.float32)])
    want = np.einsum("mkc,kco->mo", fx[np.minimum(nbr, n)], w)
    got = cuda_conv.subm_conv(*torch_args(feats, w, nbr)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    old = cuda_conv._PLAIN_CHUNK
    try:
        cuda_conv._PLAIN_CHUNK = 3 * k * cin  # three rows per chunk
        chunked = cuda_conv.subm_conv(*torch_args(feats, w, nbr)).numpy()
        np.testing.assert_allclose(chunked, want, rtol=1e-5, atol=1e-5)
    finally:
        cuda_conv._PLAIN_CHUNK = old

