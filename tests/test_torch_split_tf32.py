"""The arithmetic of the conv kernel (``csrc/gather_gemm.cuh``), held on the CPU.

The kernel keeps f32 accuracy on the tensor cores with split TF32 ("3xTF32"):
each f32 operand x becomes big = tf32(x) and small = tf32(x - big), both
rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``), and each
product is small_a*big_b + big_a*small_b + big_a*big_b; small_a*small_b is
dropped.  The kernel sums each stage of 32 reduction columns (tap, channel)
apart and adds it to the total with one rounded f32 add.

* The split, emulated here on the bit patterns: big keeps <= 10 mantissa bits
  and is x rounded to nearest with ties away; x - big is exact in f32; big +
  small == x wherever small is exact, and within 2**-22 |x| everywhere.  Edge
  values: halves, negatives, powers of two, zero, denormals, the largest
  finite value (it overflows to inf, the limit the source states) and the
  largest value that splits.
* The kernel's products, emulated in torch f32 on the CPU (per-stage blocks,
  three products, small*small dropped), through the port's conv + eval-BN ops
  on the fixtures of ``test_torch_conv.py``: within rtol = atol = 1e-5 of JAX's
  XLA conv (the tolerance of ``test_conv_bn_matches_jax_xla``), and no further
  from an f64 product than F64_FACTOR = 4 times the f32 plain version is.

The kernel itself runs only on a card (``test_torch_cuda.py``,
``chip_smoke.py`` phase 4); this file holds what its arithmetic must give.
"""

import numpy as np
import pytest
import torch

import lidal_tpu.ops.conv as jconv
from lidal_tpu_torch.ops import conv, cuda_conv
from tests.test_torch_conv import SHAPES, _call, _inputs, plan  # noqa: F401  (plan is a fixture)

F64_FACTOR = 4.0  # the emulation's distance from f64 against the f32 plain version's
STAGE = 32  # reduction columns per stage (kKS in the source)
FLT_MAX = np.float32(np.finfo(np.float32).max)


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: f32 -> the nearest value with 10 mantissa bits,
    ties away from zero (add half a tf32 ulp to the magnitude, clear 13 bits)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x: np.ndarray):
    big = tf32_rna(x)
    with np.errstate(invalid="ignore", over="ignore"):
        rest = (x - big).astype(np.float32)
    return big, tf32_rna(rest), rest


def _nearest_tf32_ties_away(x: np.ndarray) -> np.ndarray:
    """Reference rounding in f64: the nearer of the two tf32 neighbours of x,
    the one farther from zero on a tie."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    down = (bits & np.uint32(0xFFFFE000)).view(np.float32)  # toward zero
    up = ((bits & np.uint32(0xFFFFE000)) + np.uint32(0x2000)).view(np.float32)  # away from zero
    xd, dd, ud = x.astype(np.float64), down.astype(np.float64), up.astype(np.float64)
    with np.errstate(invalid="ignore"):
        take_up = np.abs(ud - xd) <= np.abs(xd - dd)
    return np.where(take_up, up, down)


def _edge_values() -> dict:
    one = np.float32(1.0)
    half = np.float32(2.0**-11)  # half a tf32 ulp at 1
    largest_split = np.nextafter(np.float32((2.0 - 2.0**-11) * 2.0**127), np.float32(0))
    return {
        "halves": np.array([one + half, one + 3 * half, 2 + 2 * half, 0.5 + half / 2, 1000.5], np.float32),
        "negatives": -np.array([one + half, one + 3 * half, 1.1, 3.0e-5, 7.0e30], np.float32),
        "powers of two": np.array([2.0**e for e in (-126, -60, -1, 0, 1, 23, 100, 127)], np.float32),
        "zero": np.array([0.0, -0.0], np.float32),
        "denormals": np.array([2.0**-149, 3 * 2.0**-149, 2.0**-127 + 2.0**-140, -(2.0**-130) * 1.2345],
                              np.float32),
        "largest that splits": np.array([largest_split, -largest_split], np.float32),
        "random": np.random.default_rng(0).standard_normal(4096).astype(np.float32)
        * np.float32(2.0) ** np.random.default_rng(1).integers(-100, 100, 4096).astype(np.float32),
    }


@pytest.mark.parametrize("name", list(_edge_values()))
def test_split_is_exact_and_rounds_to_nearest_ties_away(name):
    x = _edge_values()[name]
    big, small, rest = split_tf32(x)
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()  # <= 10 mantissa bits
    assert not (small.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_array_equal(big, _nearest_tf32_ties_away(x))
    # x - big is exact in f32, so big + rest gives x back
    np.testing.assert_array_equal(rest.astype(np.float64), x.astype(np.float64) - big.astype(np.float64))
    np.testing.assert_array_equal((big + rest).astype(np.float32), x)
    exact = small == rest
    np.testing.assert_array_equal((big + small)[exact], x[exact])
    err = np.abs(x.astype(np.float64) - big.astype(np.float64) - small.astype(np.float64))
    # 2**-22 |x|, or half the last bit small keeps in the denormal range
    assert (err <= 2.0**-22 * np.abs(x.astype(np.float64)) + 2.0**-137).all()


def test_split_overflows_only_at_the_top_of_the_range():
    """Values within 2**-11 of the largest finite float round to inf in the
    split (the limit ``gather_gemm.cuh`` states); the value below splits."""
    big, _, _ = split_tf32(np.array([FLT_MAX, -FLT_MAX], np.float32))
    assert np.isinf(big).all() and (np.sign(big) == [1, -1]).all()
    limit = np.float32((2.0 - 2.0**-11) * 2.0**127)
    assert np.isinf(tf32_rna(np.array([limit], np.float32))).all()
    assert np.isfinite(tf32_rna(np.array([np.nextafter(limit, np.float32(0))], np.float32))).all()


def _split_t(x: torch.Tensor):
    big, small, _ = split_tf32(x.numpy())
    return torch.from_numpy(big), torch.from_numpy(small)


def emulated_kernel(feats, w, nbr, scale=None, shift=None, relu=False):
    """The kernel's arithmetic in torch f32: per stage of STAGE reduction
    columns, (small_a big_b + big_a small_b) + big_a big_b summed apart, then
    added to the total; then the epilogue of ``subm_conv_plain``."""
    n, cin = feats.shape
    m, k = nbr.shape
    cout = w.shape[2]
    fb, fs = _split_t(feats)
    wb, ws = _split_t(w.reshape(k * cin, cout).contiguous())
    idx = torch.where((nbr >= 0) & (nbr < n), nbr, n).long()
    zero = feats.new_zeros((1, cin))
    gb = torch.cat([fb, zero])[idx].reshape(m, k * cin)
    gs = torch.cat([fs, zero])[idx].reshape(m, k * cin)
    acc = feats.new_zeros((m, cout))
    for c0 in range(0, k * cin, STAGE):
        c = slice(c0, c0 + STAGE)
        acc += (gs[:, c] @ wb[c] + gb[:, c] @ ws[c]) + gb[:, c] @ wb[c]
    if scale is None:
        return acc
    y = acc * scale + shift
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y * (idx.min(dim=1).values < n).to(y.dtype)[:, None]


@pytest.mark.parametrize("kind,cin,cout", SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_emulated_split_tf32_conv_matches_jax_xla_and_f64(monkeypatch, plan, kind, cin, cout, relu):  # noqa: F811
    monkeypatch.setattr(jconv, "USE_PALLAS", False)
    x, w, scale, shift = _inputs(np.random.default_rng(cin + cout), kind, cin, cout, integer=False)
    want = np.asarray(_call(kind, jconv, plan, x, w, scale, shift, relu))

    captured = []

    def emulate(feats, w_, nbr, scale_=None, shift_=None, relu_=False, order=None):  # the order changes no sum
        captured.append((feats, w_, nbr))
        return emulated_kernel(feats, w_, nbr, scale_, shift_, relu_)

    monkeypatch.setattr(cuda_conv, "subm_conv", emulate)
    got = _call(kind, conv, plan, x, w, scale, shift, relu).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    out_valid = (plan.levels[1] if kind == "down" else plan.levels[0]).valid.numpy()
    assert (got != 0).any() and (got[~out_valid] == 0).all()

    # the sums before the epilogue against f64: no further than F64_FACTOR x the f32 plain version
    (feats, w_, nbr), = captured
    ref = cuda_conv.subm_conv_plain(feats.double(), w_.double(), nbr)
    e_emul = float((emulated_kernel(feats, w_, nbr).double() - ref).abs().max())
    e_plain = float((cuda_conv.subm_conv_plain(feats, w_, nbr).double() - ref).abs().max())
    assert e_emul <= F64_FACTOR * e_plain, (e_emul, e_plain)
