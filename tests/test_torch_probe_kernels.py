"""Port parity: the plain versions of the three probe kernels
(``lidal_tpu_torch/ops/cuda_conv_bf16.py``, ``ops/cuda_conv_dxdw_fused.py``)
against the JAX package's Pallas kernels in interpret mode, and the probe entry
points (``lidal_tpu_torch/tools``) on the CPU.

The JAX probes (``tools/probe_*.py``) run at import and need the TPU, so the
reference is the kernel each probe holds itself to: ``subm_conv_pallas`` for
the two conv variants (the int8 probe requires bitwise equality with it) and
``conv_dx_dw_pallas`` for the fused backward.  Tolerances:

* small-integer data: bit-exact (exact in bf16 and in every f32 sum);
* normal data, the conv variants vs ``subm_conv_pallas``: 2**-8 of the abs-sum
  ``|bf16 feats| @ |bf16 w|``, because that kernel rounds each tap's folded
  product ``feats @ w[k]`` to bf16 (``pallas_conv.py:129-134``) and the port,
  like the probes, keeps f32 sums; against a float64 numpy product of the
  same bf16 operands: 1e-5 of the abs-sum (products of bf16 values are exact
  in f32, so only the f32 sums' order and rounding differ);
* normal data, the backward vs ``conv_dx_dw_pallas`` (f32 sums of exact
  products on both sides): 1e-5 of the abs-sum.

On the CPU the wrappers run their plain versions; ``test_torch_cuda.py``
holds the CUDA kernels against them on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidal_tpu.ops.pallas_conv as pconv
from lidal_tpu_torch.ops import cuda_conv, cuda_conv_bf16, cuda_conv_dxdw_fused
from lidal_tpu_torch.tools import probe_conv_v3, probe_dxdw_features, probe_int8_gather, timing
from tests.test_pallas_kernels import _int_feats, _sorted_nbr
from tests.test_torch_frames import torch_args

CONV_CASES = [  # (seed, n, m, cin, cout, k, groups, density): m and n multiples of 256
    (50, 256, 256, 8, 32, 27, 3, 0.8),
    (51, 512, 256, 4, 32, 27, 3, 0.4),
    (52, 256, 512, 16, 64, 8, 2, 1.0),
    (53, 512, 512, 8, 32, 8, 2, 0.0),  # all-sentinel
]

DXDW_CASES = [  # (seed, n, m, c_src, c_dst, c_f, k, groups, density), as tests/test_torch_conv_grad.py
    (40, 256, 256, 8, 16, 8, 27, 3, 0.8),
    (41, 512, 256, 16, 8, 16, 27, 3, 0.4),
    (42, 256, 512, 8, 8, 16, 8, 2, 1.0),
    (43, 512, 512, 16, 16, 8, 8, 2, 0.0),  # all-sentinel: zero grads
]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _conv_inputs(seed, n, m, cin, cout, k, density, integer):
    rng = np.random.default_rng(seed)
    if integer:
        feats = _int_feats(rng, n, cin)
        w = rng.integers(-3, 4, size=(k, cin, cout)).astype(np.float32)
    else:
        feats = rng.standard_normal((n, cin)).astype(np.float32)
        w = (rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    return feats, w, _sorted_nbr(rng, m, k, n, density)


@pytest.mark.parametrize("seed,n,m,cin,cout,k,groups,density", CONV_CASES)
def test_gather_first_and_byte_planes_bit_exact_vs_pallas_interpret(seed, n, m, cin, cout, k, groups, density):
    feats, w, nbr = _conv_inputs(seed, n, m, cin, cout, k, density, integer=True)
    want = np.asarray(pconv.subm_conv_pallas(jnp.asarray(feats), jnp.asarray(w), jnp.asarray(nbr), groups=groups, interpret=True))
    tf, tw, tn = torch_args(feats, w, nbr)
    for pipelined in (False, True):
        np.testing.assert_array_equal(cuda_conv_bf16.conv_gather_first(tf, tw, tn, pipelined=pipelined).numpy(), want)
    np.testing.assert_array_equal(cuda_conv_bf16.conv_byte_planes(cuda_conv_bf16.to_byte_planes(tf), tw, tn).numpy(), want)
    assert (density > 0) == bool(np.abs(want).sum() > 0)


@pytest.mark.parametrize("seed,n,m,cin,cout,k,groups,density", CONV_CASES[:3])
def test_gather_first_on_normal_data(seed, n, m, cin, cout, k, groups, density):
    feats, w, nbr = _conv_inputs(seed, n, m, cin, cout, k, density, integer=False)
    tf, tw, tn = torch_args(feats, w, nbr)
    got = cuda_conv_bf16.conv_gather_first(tf, tw, tn).numpy()
    fb, wb = _bf16(feats), _bf16(w)
    fx = np.concatenate([fb, np.zeros((1, cin), np.float32)]).astype(np.float64)
    oracle = np.einsum("mkc,kco->mo", fx[nbr], wb.astype(np.float64))
    abs_sum = np.einsum("mkc,kco->mo", np.abs(fx)[nbr], np.abs(wb).astype(np.float64))
    assert (np.abs(got - oracle) <= 1e-5 * abs_sum).all()
    pallas = np.asarray(pconv.subm_conv_pallas(jnp.asarray(feats), jnp.asarray(w), jnp.asarray(nbr), groups=groups, interpret=True))
    assert (np.abs(got - pallas) <= 2.0**-8 * abs_sum).all()
    # the bf16 rounding is there: the f32 conv on the same inputs differs
    assert np.abs(got - cuda_conv.subm_conv(tf, tw, tn).numpy()).max() > 1e-4
    # and the byte planes carry the same bits
    planes = cuda_conv_bf16.to_byte_planes(tf)
    np.testing.assert_array_equal(cuda_conv_bf16.conv_byte_planes(planes, tw, tn).numpy(), got)


def test_byte_planes_round_trip_over_every_bf16_pattern():
    bits = torch.arange(65536, dtype=torch.int32)
    bf = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16).view(torch.bfloat16).reshape(4096, 16)
    planes = cuda_conv_bf16.to_byte_planes(bf)
    assert planes.dtype == torch.int8 and planes.shape == (4096, 32)
    back = cuda_conv_bf16.from_byte_planes(planes)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), bf.view(torch.int16))
    # the low-byte plane comes first, then the high-byte plane; bytes above 127 are negative int8
    u = bits.reshape(4096, 16)
    assert torch.equal(planes[:, :16].to(torch.int32) & 0xFF, u & 0xFF)
    assert torch.equal(planes[:, 16:].to(torch.int32) & 0xFF, u >> 8)
    assert int(planes.min()) == -128 and int(planes.max()) == 127


@pytest.mark.parametrize("cin,cin_pad", [(4, 16), (16, 16), (20, 32), (96, 96)])
def test_packing_pads_input_channels_to_sixteen(cin, cin_pad):
    rng = np.random.default_rng(cin)
    feats, w = torch_args(rng.standard_normal((30, cin)).astype(np.float32), rng.standard_normal((8, cin, 32)).astype(np.float32))
    table, wt, planes = cuda_conv_bf16.pack_table(feats), cuda_conv_bf16.pack_weights(w), cuda_conv_bf16.to_byte_planes(feats)
    assert table.shape == (30, cin_pad) and table.dtype == torch.bfloat16 and table.is_contiguous()
    assert wt.shape == (8, 32, cin_pad) and wt.is_contiguous() and planes.shape == (30, 2 * cin_pad)
    assert torch.equal(table[:, :cin], feats.to(torch.bfloat16)) and not table[:, cin:].any()
    assert torch.equal(wt[:, :, :cin], w.to(torch.bfloat16).transpose(1, 2)) and not wt[:, :, cin:].any()
    assert torch.equal(cuda_conv_bf16.from_byte_planes(planes), table)


def test_conv_wrappers_refuse_what_does_not_fit():
    feats, w, nbr = torch.zeros((10, 8)), torch.zeros((27, 8, 32)), torch.zeros((5, 27), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_conv_bf16.conv_gather_first(feats, w[:8], nbr)  # K of w and of the map differ
    with pytest.raises(ValueError):
        cuda_conv_bf16.conv_gather_first(feats, torch.zeros((27, 40, 32)), nbr)  # cin
    with pytest.raises(ValueError):
        cuda_conv_bf16.conv_byte_planes(torch.zeros((10, 32), dtype=torch.int16), w, nbr)  # not int8
    with pytest.raises(ValueError):
        cuda_conv_bf16.conv_byte_planes(torch.zeros((10, 64), dtype=torch.int8), w, nbr)  # planes of 32 channels, w of 8
    with pytest.raises(ValueError):
        cuda_conv_bf16.gather_first_packed(cuda_conv_bf16.pack_table(feats), cuda_conv_bf16.pack_weights(w), nbr)  # CPU
    with pytest.raises(ValueError):
        cuda_conv_dxdw_fused.conv_dx_dw_fused(feats, w, nbr, torch.zeros((5, 8)), mode="dw")


@pytest.mark.parametrize("unsorted", [False, True])
@pytest.mark.parametrize("seed,n,m,c_src,c_dst,c_f,k,groups,density", DXDW_CASES)
def test_fused_backward_bit_exact_vs_pallas_interpret(seed, n, m, c_src, c_dst, c_f, k, groups, density, unsorted):
    rng = np.random.default_rng(seed)
    src = _int_feats(rng, n, c_src)
    w2 = rng.integers(-3, 4, size=(k, c_src, c_dst)).astype(np.float32)
    f = _int_feats(rng, m, c_f)
    nbr = _sorted_nbr(rng, m, k, n, density)
    if unsorted:  # each column's entries shuffled over the rows, sentinels included
        nbr = np.stack([rng.permutation(nbr[:, j]) for j in range(k)], axis=1)
    dx_j, dw_j = pconv.conv_dx_dw_pallas(
        jnp.asarray(src), jnp.asarray(w2), jnp.asarray(nbr), jnp.asarray(f), groups=groups, interpret=True
    )
    dx, dw = cuda_conv_dxdw_fused.conv_dx_dw_fused(*torch_args(src, w2, nbr, f), mode="dx_dw")
    np.testing.assert_array_equal(dx.numpy(), np.asarray(dx_j))
    np.testing.assert_array_equal(dw.numpy(), np.asarray(dw_j))
    assert dw.shape == (k, c_f, c_src) and (density > 0) == bool(dw.abs().sum() > 0)


@pytest.mark.parametrize("seed,n,m,c_src,c_dst,c_f,k,groups,density", DXDW_CASES[:3])
def test_fused_backward_on_normal_data_and_its_three_modes(seed, n, m, c_src, c_dst, c_f, k, groups, density):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((n, c_src)).astype(np.float32)
    w2 = rng.standard_normal((k, c_src, c_dst)).astype(np.float32)
    f = rng.standard_normal((m, c_f)).astype(np.float32)
    nbr = _sorted_nbr(rng, m, k, n, density)
    dx_j, dw_j = pconv.conv_dx_dw_pallas(
        jnp.asarray(src), jnp.asarray(w2), jnp.asarray(nbr), jnp.asarray(f), groups=groups, interpret=True
    )
    args = torch_args(src, w2, nbr, f)
    dx, dw = cuda_conv_dxdw_fused.conv_dx_dw_fused(*args, mode="dx_dw")
    abs_dx, abs_dw = cuda_conv_dxdw_fused.conv_dx_dw_fused_plain(*(a.abs() if a.is_floating_point() else a for a in args))
    assert bool(((dx - torch.from_numpy(np.asarray(dx_j))).abs() <= 1e-5 * abs_dx).all())
    assert bool(((dw - torch.from_numpy(np.asarray(dw_j))).abs() <= 1e-5 * abs_dw).all())
    dx_a, none = cuda_conv_dxdw_fused.conv_dx_dw_fused(*args, mode="dx")
    dx_b, zeros = cuda_conv_dxdw_fused.conv_dx_dw_fused(*args, mode="dx_zero_dw")
    assert none is None and torch.equal(dx_a, dx) and torch.equal(dx_b, dx)
    assert zeros.shape == dw.shape and zeros.dtype == torch.float32 and not zeros.any()


@pytest.mark.parametrize("cout,bn", [(32, 32), (64, 64), (96, 96), (128, 128), (192, 96), (256, 128), (384, 128)])
def test_column_tile_is_the_widest_that_divides_cout(cout, bn):
    assert cuda_conv_bf16.column_tile(cout) == bn
    assert all(cout % t for t in cuda_conv_bf16.COLUMN_TILES if t > bn)


def test_column_tile_refuses_what_the_kernel_cannot_tile():
    with pytest.raises(ValueError):
        cuda_conv_bf16.column_tile(48)


@pytest.mark.parametrize("bn,m,cout,rows", [(32, 131072, 32, 128), (64, 81920, 64, 128), (96, 49152, 96, 192),
                                           (96, 16384, 96, 128), (128, 16384, 128, 128), (128, 6144, 384, 128),
                                           (128, 655360, 128, 192)])
def test_tile_rows_take_a_third_warpgroup_where_the_grid_stays_full(bn, m, cout, rows):
    """192-row tiles (three warpgroups) only at column tiles of 96 or 128 and
    where they still make 200 blocks; else 128 rows."""
    assert cuda_conv_bf16.tile_rows(bn, m, cout) == rows


@pytest.mark.parametrize("bn,rows,header", [(32, 128, 14336), (64, 128, 14336), (96, 128, 14336), (128, 128, 14336),
                                            (96, 192, 21504), (128, 192, 21504)])
def test_ring_stages_fit_an_sm_and_pipelined_is_the_deeper_ring(bn, rows, header):
    """The deep ring fills an SM's 232448 bytes of dynamic shared memory with
    stages of (rows + bn) x 64 bf16 beside the tile's header (its map of 27
    taps and 65 more ints, in 1024-byte units) and 1024 bytes of alignment,
    at most 8 stages; the shallow one is 4 stages."""
    shallow, deep = cuda_conv_bf16.ring_stages(bn, rows, False), cuda_conv_bf16.ring_stages(bn, rows, True)
    stage = (rows + bn) * 64 * 2
    assert cuda_conv_bf16.smem_bytes(bn, rows, deep) == header + deep * stage + 1024
    assert shallow == 4 and 4 <= deep <= 8
    assert header + deep * stage + 1024 <= 232448
    assert deep == 8 or header + (deep + 1) * stage + 1024 > 232448


@pytest.mark.parametrize("m,k,cin,density", [(300, 27, 16, 0.05), (256, 8, 96, 0.3), (1000, 27, 32, 0.0), (129, 27, 256, 1.0)])
def test_tile_products_count_the_active_taps_of_each_tile(m, k, cin, density):
    """Per row tile (128 rows at cout = 64): ceil(active taps x cin / 64)
    stages of 64 columns x the tile's rows x cout, the tile padded with
    sentinel rows past m."""
    rng = np.random.default_rng(m + k)
    n = 500
    nbr = rng.integers(0, n, (m, k)).astype(np.int32)
    nbr[rng.random((m, k)) >= density] = n
    nbr[0, 0] = -3  # below 0 is a sentinel too
    want = 0
    for r0 in range(0, m, 128):
        tile = nbr[r0 : r0 + 128]
        active = int(((tile >= 0) & (tile < n)).any(0).sum())
        want += -(-active * cin // 64) * 64 * 128 * 64
    assert cuda_conv_bf16.tile_products(torch.from_numpy(nbr), n, cin, 64) == want
    assert (want == 0) == (density == 0.0)


@pytest.mark.parametrize("c,padded", [(4, 32), (8, 32), (32, 32), (96, 96), (100, 128), (384, 384)])
def test_fused_backward_pads_channels_to_thirty_two(c, padded):
    assert cuda_conv_dxdw_fused.padded_channels(c, c, c) == (padded, padded, padded)


@pytest.mark.parametrize("m,k,c_f,c_src", [(655360, 27, 96, 96), (30720, 27, 384, 256), (512, 8, 32, 32), (0, 27, 32, 32), (5000, 8, 32, 64)])
def test_fused_dw_chunks_are_whole_stages_and_bound_the_workspace(m, k, c_f, c_src):
    """The bf16 dW kernel's chunks: whole 128-pair stages, enough to cover
    every row of a tap, and a workspace [K, S, c_f, c_src] within 256 MB
    unless one chunk a tap already exceeds it."""
    chunks, p = cuda_conv_dxdw_fused.dw_chunks(m, k, c_f, c_src)
    assert chunks >= 1 and p % cuda_conv_dxdw_fused.PAIRS_PER_STAGE == 0 and p >= 1024 or m == 0
    assert chunks * p >= m and (chunks - 1) * p < max(m, 1)
    assert chunks * k * c_f * c_src * 4 <= max(256 << 20, k * c_f * c_src * 4)


def test_device_time_on_cpu_tensors():
    calls = []

    def fn(x, y):
        calls.append(1)
        return x @ y

    ms = timing.device_time(fn, (torch.ones((8, 8)), torch.ones((8, 8))), iters=3, reps=2)
    assert ms > 0 and len(calls) == 1 + 3 * 2
    with pytest.raises(ValueError):
        timing.device_time(lambda: None, ())


def test_probe_entry_points_run_on_the_cpu(capsys):
    rows = probe_conv_v3.main("cpu", shapes=((1024, 4, 32, "stem1"), (512, 32, 32, "stem2")), iters=1)
    assert [r["label"] for r in rows] == ["stem1", "stem2"] and all(r["pipelined_ms"] > 0 for r in rows)
    rows = probe_int8_gather.main("cpu", n=1024, shapes=((32, 32),), iters=1)
    assert rows[0]["max_abs_diff"] == 0.0
    rows = probe_dxdw_features.main("cpu", step_shapes=(("small", 1024, 27, 32, 32, 64),), iters=1)
    assert [r["label"] for r in rows] == ["probe", "small"] and (rows[0]["m"], rows[0]["k"], rows[0]["c_src"]) == (512, 8, 8)
    out = capsys.readouterr().out
    assert "gather-first" in out and "+pipelined" in out and "bitwise=True" in out and "int8-bytes" in out
    assert out.count(" ok ") == 6 and "A fwd-only" in out and "C + dw math, carry, RMW" in out


def test_probe_maps_are_banded_sorted_and_hold_sentinels():
    rng = np.random.default_rng(0)
    for make, n in ((probe_conv_v3.make_nbr, 4096), (probe_int8_gather.make_nbr, 4096)):
        nbr = make(rng, n, 27, 300)
        assert nbr.shape == (n, 27) and nbr.dtype == np.int32
        assert (np.diff(nbr, axis=0) >= 0).all() and nbr.min() >= 0 and nbr.max() == n
        assert 0.05 < (nbr == n).mean() < 0.5
    src, w2, nbr, f = probe_dxdw_features.probe_inputs(np.random.default_rng(0))
    assert src.shape == (512, 8) and w2.shape == (8, 8, 8) and f.shape == (512, 8)
    assert ((nbr < 512).sum(0) == 400).all()
