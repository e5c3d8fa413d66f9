"""Port parity: the sparse-conv backward (``lidal_tpu_torch/ops/cuda_conv_dxdw.py``
and the autograd convs of ``ops/conv.py``) against the JAX package.

* ``conv_dx_dw_plain`` vs ``conv_dx_dw_pallas(..., interpret=True)``:
  bit-exact on small integers (exact in the TPU kernel's bf16 staging and in
  every f32 sum), on the cases of ``test_pallas_kernels.py`` (the all-sentinel
  one included) and on maps whose columns are not sorted;
* ``subm/down/up_conv_batched`` forward and both gradients vs ``jax.vjp`` of
  the JAX functions on a real plan: the XLA path at rtol = 1e-5 and atol =
  1e-5 * max(1, max |JAX|) (f32 sums of up to ~1000 products in another
  order; dW entries that cancel keep the rounding of their largest partial
  sums), and the interpret-mode
  Pallas route (``USE_PALLAS = True``) bit-exact on integer data;
* ``torch.autograd.gradcheck`` of the three convs in float64 on a tiny plan.

On the CPU the wrappers run their plain versions; ``test_torch_cuda.py``
holds the CUDA kernel against them on the card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidal_tpu.ops.conv as jconv
import lidal_tpu.ops.pallas_conv as pconv
from lidal_tpu_torch.data.augment import augment_and_voxelize
from lidal_tpu_torch.ops import conv, cuda_conv_dxdw
from lidal_tpu_torch.ops.kernel_map import build_unet_plan
from tests.test_pallas_kernels import _int_feats, _sorted_nbr
from tests.test_torch_frames import surface_frames, torch_args

# Pallas needs m and n to be multiples of 256: B = 2 frames of these caps.
CAPS = (512, 256, 256, 256, 256)

DXDW_CASES = [  # (seed, n, m, c_src, c_dst, c_f, k, groups, density), test_pallas_kernels.py
    (40, 256, 256, 8, 16, 8, 27, 3, 0.8),
    (41, 512, 256, 16, 8, 16, 27, 3, 0.4),
    (42, 256, 512, 8, 8, 16, 8, 2, 1.0),
    (43, 512, 512, 16, 16, 8, 8, 2, 0.0),  # all-sentinel: zero grads
    (44, 768, 256, 8, 8, 8, 27, 3, 0.15),
]


@pytest.mark.parametrize("unsorted", [False, True])
@pytest.mark.parametrize("seed,n,m,c_src,c_dst,c_f,k,groups,density", DXDW_CASES)
def test_plain_dx_dw_bit_exact_vs_pallas_interpret(seed, n, m, c_src, c_dst, c_f, k, groups, density, unsorted):
    rng = np.random.default_rng(seed)
    src = _int_feats(rng, n, c_src)
    w2 = rng.integers(-3, 4, size=(k, c_src, c_dst)).astype(np.float32)
    f = _int_feats(rng, m, c_f)
    nbr = _sorted_nbr(rng, m, k, n, density)
    if unsorted:  # each column's entries shuffled over the rows, sentinels included
        nbr = np.stack([rng.permutation(nbr[:, j]) for j in range(k)], axis=1)
    dx_j, dwg_j = pconv.conv_dx_dw_pallas(
        jnp.asarray(src), jnp.asarray(w2), jnp.asarray(nbr), jnp.asarray(f), groups=groups, interpret=True
    )
    dx, dwg = cuda_conv_dxdw.conv_dx_dw(*torch_args(src, w2, nbr, f))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(dx_j))
    np.testing.assert_array_equal(dwg.numpy(), np.asarray(dwg_j))
    assert dwg.shape == (k, c_f, c_src) and (density > 0) == bool(dwg.abs().sum() > 0)


def test_plain_dx_dw_chunks_and_need_dx():
    """The im2col chunks cover every row, and ``need_dx=False`` gives the
    same dwg and no dx."""
    rng = np.random.default_rng(3)
    n, m, k, c_src, c_dst, c_f = 50, 70, 8, 12, 16, 4
    src, w2, f = (rng.standard_normal(s).astype(np.float32) for s in ((n, c_src), (k, c_src, c_dst), (m, c_f)))
    nbr = rng.integers(0, n + 5, (m, k)).astype(np.int32)  # any index >= n contributes zero
    sx = np.concatenate([src, np.zeros((1, c_src), np.float32)])[np.minimum(nbr, n)]
    want_dx = np.einsum("mks,ksd->md", sx, w2)
    want_dwg = np.einsum("mf,mks->kfs", f, sx)
    args = torch_args(src, w2, nbr, f)
    old = cuda_conv_dxdw._PLAIN_CHUNK
    try:
        for chunk in (old, 3 * k * c_src):  # whole, then three rows per chunk
            cuda_conv_dxdw._PLAIN_CHUNK = chunk
            dx, dwg = cuda_conv_dxdw.conv_dx_dw(*args)
            np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(dwg.numpy(), want_dwg, rtol=1e-5, atol=1e-5)
    finally:
        cuda_conv_dxdw._PLAIN_CHUNK = old
    no_dx, dwg2 = cuda_conv_dxdw.conv_dx_dw(*args, need_dx=False)
    assert no_dx is None
    np.testing.assert_array_equal(dwg2.numpy(), cuda_conv_dxdw.conv_dx_dw(*args)[1].numpy())


@pytest.mark.parametrize("m,k,c_f,c_src", [(655360, 27, 4, 32), (655360, 27, 128, 96), (30720, 27, 384, 256), (5, 8, 8, 32), (0, 27, 4, 32)])
def test_row_chunks_cover_rows_and_bound_the_workspace(m, k, c_f, c_src):
    chunks, rows = cuda_conv_dxdw.row_chunks(m, k, c_f, c_src)
    assert chunks >= 1 and rows % 32 == 0 or m == 0
    assert chunks * rows >= m and (chunks - 1) * rows < max(m, 1)
    assert chunks * k * c_f * c_src * 4 <= max(256 << 20, k * c_f * c_src * 4)


@pytest.fixture(scope="module")
def plan():
    xyz, sig, valid, _ = surface_frames(21, b=2, p=1024, n=420, span=5.0)
    vf = augment_and_voxelize(None, *torch_args(xyz, sig, valid), CAPS[0], augment=False)
    return build_unet_plan(vf.uv.coords, vf.uv.valid, CAPS)


@pytest.fixture
def pallas_on(monkeypatch):
    monkeypatch.setattr(pconv, "subm_conv_pallas", functools.partial(pconv.subm_conv_pallas, interpret=True))
    monkeypatch.setattr(pconv, "conv_dx_dw_pallas", functools.partial(pconv.conv_dx_dw_pallas, interpret=True))
    monkeypatch.setattr(jconv, "USE_PALLAS", True)


@pytest.fixture
def xla_conv(monkeypatch):
    monkeypatch.setattr(jconv, "USE_PALLAS", False)


def _maps(kind, plan):
    """The batched conv's map arguments, as numpy arrays."""
    if kind == "subm":
        return (plan.levels[0].nbr3.numpy(),)
    d = plan.downs[0]
    return d.child.numpy(), d.parent.numpy(), d.pdelta.numpy()


def _jax_vjp(kind, plan, x, w, dy):
    fn = {"subm": jconv.subm_conv_batched, "down": jconv.down_conv_batched, "up": jconv.up_conv_batched}[kind]
    maps = [jnp.asarray(a) for a in _maps(kind, plan)]
    out, vjp = jax.vjp(lambda xx, ww: fn(xx, ww, *maps), jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(dy))
    return [np.asarray(a) for a in (out, dx, dw)]


def _port_vjp(kind, plan, x, w, dy):
    fn = {"subm": conv.subm_conv_batched, "down": conv.down_conv_batched, "up": conv.up_conv_batched}[kind]
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = fn(xt, wt, *torch_args(*_maps(kind, plan)))
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(dy))
    return [a.detach().numpy() for a in (out, dx, dw)]


def _inputs(rng, kind, cin, cout, integer):
    src_cap, out_cap = (CAPS[0], CAPS[0]) if kind == "subm" else ((CAPS[0], CAPS[1]) if kind == "down" else (CAPS[1], CAPS[0]))
    k = 27 if kind == "subm" else 8
    if integer:
        # the TPU forward rounds each tap's product to bf16, which holds
        # integers exactly up to 256: keep cin * |x| * |w| within that
        a = 4 if cin <= 16 else 1
        x = rng.integers(-a, a + 1, (2, src_cap, cin)).astype(np.float32)
        w = rng.integers(-a, a + 1, (k, cin, cout)).astype(np.float32)
        dy = rng.integers(-4, 5, (2, out_cap, cout)).astype(np.float32)
    else:
        x = rng.standard_normal((2, src_cap, cin)).astype(np.float32)
        w = (rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
        dy = rng.standard_normal((2, out_cap, cout)).astype(np.float32)
    return x, w, dy


SHAPES = [("subm", 4, 32), ("subm", 32, 16), ("down", 16, 32), ("up", 32, 16)]


@pytest.mark.parametrize("kind,cin,cout", SHAPES)
def test_conv_grads_match_jax_xla(xla_conv, plan, kind, cin, cout):
    x, w, dy = _inputs(np.random.default_rng(cin + cout), kind, cin, cout, integer=False)
    got = _port_vjp(kind, plan, x, w, dy)
    want = _jax_vjp(kind, plan, x, w, dy)
    for name, g, wv in zip(("out", "dx", "dw"), got, want):
        assert g.shape == wv.shape, name
        # an entry that cancels to near zero keeps the rounding of its larger
        # partial sums: the absolute tolerance scales with the largest entry
        np.testing.assert_allclose(g, wv, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(wv).max()), err_msg=name)
    assert np.abs(got[2]).max() > 0 and np.abs(got[1]).max() > 0


@pytest.mark.parametrize("kind,cin,cout", SHAPES)
def test_conv_grads_bit_exact_vs_pallas_interpret(pallas_on, plan, kind, cin, cout):
    x, w, dy = _inputs(np.random.default_rng(3 * cin + cout), kind, cin, cout, integer=True)
    got = _port_vjp(kind, plan, x, w, dy)
    want = _jax_vjp(kind, plan, x, w, dy)
    for name, g, wv in zip(("out", "dx", "dw"), got, want):
        np.testing.assert_array_equal(g, wv, err_msg=name)


def test_conv_gradcheck_float64():
    """Numerical vs analytic gradients of the three convs on a tiny real plan:
    the mirror identity (subm) and the child/parent pairing (down, up) hold
    on the rulebooks the plan builds."""
    xyz, sig, valid, _ = surface_frames(5, b=1, p=128, n=90, span=0.4)
    caps = (128, 64, 32, 16, 8)
    vf = augment_and_voxelize(None, *torch_args(xyz, sig, valid), caps[0], augment=False)
    p = build_unet_plan(vf.uv.coords, vf.uv.valid, caps)
    d = p.downs[0]
    assert int(p.levels[0].num_valid.sum()) > 20 and int(p.levels[1].num_valid.sum()) > 5
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64).requires_grad_()

    cases = [
        (conv.subm_conv_batched, rand(1, caps[0], 2), rand(27, 2, 3), (p.levels[0].nbr3,)),
        (conv.down_conv_batched, rand(1, caps[0], 2), rand(8, 2, 3), (d.child, d.parent, d.pdelta)),
        (conv.up_conv_batched, rand(1, caps[1], 2), rand(8, 2, 3), (d.child, d.parent, d.pdelta)),
    ]
    for fn, x, w, maps in cases:
        assert torch.autograd.gradcheck(lambda xx, ww: fn(xx, ww, *maps), (x, w), eps=1e-6, atol=1e-8)
