"""The weight-gradient half of the conv backward kernel (``csrc/conv_dx_dw.cu``),
held on the CPU.

The kernel computes dwg[k] = sum_i f[i]^T src[nbr[i, k]] over per-tap lists
of the real (row, tap) pairs, in chunks of P pairs and stages of 64 pairs, on
the tensor cores in split TF32 (three tf32 products per f32 product); each
stage's products are summed apart and added to a warp group's total with one
rounded f32 add, the groups of a block are summed in order, and the chunks'
partials are summed in chunk order.

* The pair lists (``pair_lists_plain``, the plain version of the lists the
  kernel builds) against numpy per tap: the sentinel n, negative and > n
  indices, an empty tap, an all-sentinel map, m = 0 and unsorted columns.
* The kernel's arithmetic, emulated here in torch f32 (the split, the
  per-stage blocked sums, the warp groups, chunks of P pairs and partials in
  order), through the port's autograd convs on the plan of
  ``test_torch_conv_grad.py``: dW within rtol = 1e-5 and atol = 1e-5 * max(1,
  max |JAX|) of JAX's conv gradients through XLA (the tolerance of
  ``test_conv_grads_match_jax_xla``) for subm, down and up, at the shape's own
  P and at one stage a chunk; and no further from an f64 product than
  F64_FACTOR = 4 times the f32 plain version is.

The kernel itself runs only on a card (``test_torch_cuda.py``,
``chip_smoke.py`` phase 7); this file holds what its arithmetic must give.
"""

import numpy as np
import pytest
import torch

import lidal_tpu.ops.conv as jconv
from lidal_tpu_torch.ops import cuda_conv_dxdw
from tests.test_torch_conv_grad import SHAPES, _inputs, _jax_vjp, _port_vjp, plan  # noqa: F401  (plan is a fixture)
from tests.test_torch_split_tf32 import split_tf32

F64_FACTOR = 4.0  # the emulation's distance from f64 against the f32 plain version's
STAGE = 64  # pairs per stage (kStage in the source)


def _map(case, rng):
    """(nbr_t [K, m] int32, n) of one compaction case."""
    n, k, m = 300, 27, 1000
    nbr_t = rng.integers(0, n, (k, m)).astype(np.int32)
    nbr_t[rng.random((k, m)) < 0.6] = n
    if case == "negative and > n":
        neg, big = rng.random((2, k, m)) < 0.15
        nbr_t[neg] = -rng.integers(1, 1 << 30, int(neg.sum()))
        nbr_t[big] = n + rng.integers(1, 1 << 30, int(big.sum()))
    elif case == "empty tap":
        nbr_t[4] = n
    elif case == "all sentinel":
        nbr_t[:] = n
    elif case == "m = 0":
        nbr_t = nbr_t[:, :0]
    elif case == "unsorted columns":  # each tap's entries shuffled over the rows
        nbr_t = np.stack([rng.permutation(c) for c in nbr_t])
    elif case == "several segments":  # more rows than one 4096-row list block scans
        nbr_t = rng.integers(-2, n + 2, (3, 9000)).astype(np.int32)
    return nbr_t, n


@pytest.mark.parametrize("case", ["sentinel n", "negative and > n", "empty tap", "all sentinel", "m = 0",
                                  "unsorted columns", "several segments"])
def test_pair_lists_match_numpy(case):
    nbr_t, n = _map(case, np.random.default_rng(len(case)))
    k, m = nbr_t.shape
    rows, counts = cuda_conv_dxdw.pair_lists_plain(torch.from_numpy(nbr_t), n)
    assert rows.dtype == counts.dtype == torch.int32 and rows.shape == (k, m) and counts.shape == (k,)
    for tap in range(k):
        want = np.flatnonzero((nbr_t[tap] >= 0) & (nbr_t[tap] < n))
        assert int(counts[tap]) == len(want)
        np.testing.assert_array_equal(rows[tap, : len(want)].numpy(), want)
        assert (rows[tap, len(want):] == m).all()
    if case in ("empty tap", "all sentinel"):
        assert int(counts[4]) == 0
    if case == "all sentinel":
        assert not counts.any()


def _warp_groups(c_f: int, c_src: int) -> int:
    """Warp groups that split a stage's pairs in the kernel's tile for this
    shape (``DwTile::WK`` of the source): 8 warps of 32 x 32 outputs (32 x 8
    when c_f % 32 != 0) over a TM x TN tile, TM = 128, 64 or 32 of c_f (of
    c_src when c_f % 32 != 0), TN = 64 or 32 of c_src (8 of c_f)."""
    tn = 64 if c_src % 64 == 0 else 32
    if c_f % 32:
        return 8 // (tn // 32)
    tm = 128 if c_f % 128 == 0 else (64 if c_f % 64 == 0 else 32)
    return 8 // ((tm // 32) * (tn // 32))


def _split_t(x: torch.Tensor):
    big, small, _ = split_tf32(x.detach().numpy())
    return torch.from_numpy(big), torch.from_numpy(small)


def emulated_dwg(src, nbr, f, per_chunk=None):
    """The kernel's dwg in torch f32: per tap, its list of real pairs in chunks
    of P pairs; per stage of STAGE pairs and warp group, (small_f big_s +
    big_f small_s) + big_f big_s summed apart and added to the group's total;
    the groups summed in order, then the tap's first max(1, ceil(count / P))
    chunk partials in order."""
    n, c_src = src.shape
    m, k = nbr.shape
    c_f = f.shape[1]
    chunks, p = cuda_conv_dxdw.pair_chunks(m, k, c_f, c_src)
    if per_chunk is not None:
        chunks, p = max(1, -(-m // per_chunk)), per_chunk
    groups = _warp_groups(c_f, c_src)
    rows, counts = cuda_conv_dxdw.pair_lists_plain(nbr.t().contiguous(), n)
    fb, fs = _split_t(f)
    sb, ss = _split_t(src)
    dwg = f.new_zeros((k, c_f, c_src))
    for tap in range(k):
        cnt = int(counts[tap])
        i = rows[tap, :cnt].long()
        j = nbr[i, tap].long()
        used = max(1, -(-cnt // p))

        def staged(x):  # [used * p, c] -> [used, stages, groups, pairs of a group's share, c]
            x = torch.cat([x, x.new_zeros((used * p - cnt, x.shape[1]))])
            return x.reshape(used, p // STAGE, groups, STAGE // groups, x.shape[1])

        xb, xs, yb, ys = staged(fb[i]), staged(fs[i]), staged(sb[j]), staged(ss[j])
        prod = (torch.einsum("ugqpa,ugqpb->ugqab", xs, yb) + torch.einsum("ugqpa,ugqpb->ugqab", xb, ys)) \
            + torch.einsum("ugqpa,ugqpb->ugqab", xb, yb)
        acc = prod.new_zeros((used, groups, c_f, c_src))
        for s in range(p // STAGE):
            acc += prod[:, s]
        part = acc[:, 0].clone()
        for g in range(1, groups):
            part += acc[:, g]
        out = part[0].clone()
        for c in range(1, used):
            out += part[c]
        dwg[tap] = out
    return dwg


@pytest.mark.parametrize("kind,cin,cout", SHAPES)
@pytest.mark.parametrize("per_chunk", [None, STAGE])
def test_emulated_dwg_matches_jax_xla_and_f64(monkeypatch, plan, kind, cin, cout, per_chunk):  # noqa: F811
    monkeypatch.setattr(jconv, "USE_PALLAS", False)
    x, w, dy = _inputs(np.random.default_rng(cin + cout), kind, cin, cout, integer=False)
    want = _jax_vjp(kind, plan, x, w, dy)

    captured = []
    plain = cuda_conv_dxdw.conv_dx_dw_plain

    def emulate(src, w2, nbr, f, need_dx=True):
        captured.append((src.detach(), nbr, f.detach()))
        dx, _ = plain(src, w2, nbr, f, need_dx)
        return dx, emulated_dwg(src, nbr, f, per_chunk)

    monkeypatch.setattr(cuda_conv_dxdw, "conv_dx_dw", emulate)
    got = _port_vjp(kind, plan, x, w, dy)
    for name, g, wv in zip(("out", "dx", "dw"), got, want):
        np.testing.assert_allclose(g, wv, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(wv).max()), err_msg=name)
    assert np.abs(got[2]).max() > 0

    # dwg against f64: no further than F64_FACTOR x the f32 plain version
    (src, nbr, f), = captured
    if per_chunk is not None:  # the lists span several chunks
        counts = cuda_conv_dxdw.pair_lists_plain(nbr.t().contiguous(), src.shape[0])[1]
        assert int(counts.max()) > per_chunk
    w0 = torch.zeros((nbr.shape[1], src.shape[1], 1))  # dx is not asked for; w2 only has to fit
    ref = plain(src.double(), w0.double(), nbr, f.double(), need_dx=False)[1]
    e_emul = float((emulated_dwg(src, nbr, f, per_chunk).double() - ref).abs().max())
    e_plain = float((plain(src, w0, nbr, f, need_dx=False)[1].double() - ref).abs().max())
    assert e_emul <= F64_FACTOR * e_plain, (e_emul, e_plain)
