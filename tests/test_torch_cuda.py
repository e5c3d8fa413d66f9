"""The port's CUDA kernels against their plain versions, on the card.

This module imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)  Without a
card the ``cuda`` tests skip; the device check itself runs everywhere.

Tolerances: lookups are bit-equal; a conv output and the backward's dx within
1e-4 * max(1, |plain|) (f32 sums of up to 27 * 384 products in another order;
the kernel's products are split TF32, three tf32 products per f32 product,
no further from f64 than 4 times the f32 plain version plus 1e-6 of the
abs-sum, and bit-equal on reruns; with the row order of the plan's maps
bit-equal to the rows as they are wherever cin >= 32, the stem within the
same gate, and ``conv.row_order`` counted at each launch that walks one);
the backward's dwg within 1e-4 * max(1, plain_abs), where plain_abs
is the plain version on |src| and |f| (a reordered f32 sum over every row);
a forward's logits within 1e-4 on these small frames; a train step's
gradients with the backward kernel within 1e-4 of each gradient's max of
the plain backward's, under one forward.  ``gather8`` is bit-equal to its
plain version (the same products and sums in the same order, no FMA);
``scatter8`` within 1e-5 of ``sum |w8| |dy|`` per target of its plain version
(``index_add_``, atomics in no fixed order on a card), no further from the plain
version in f64 than 4 times the f32 plain version is, and bit-equal across
two runs; its transposed map, built on the card, equal to ``build_transpose``'s.
``nn_band``'s pruned scan is bit-equal to the plain version and evaluates
fewer pairs than its bands hold, also at nuScenes's map coordinates, where
``build_grid`` on the card equals the CPU's.  The bf16 probe kernels (``conv_gather_first``, ``conv_byte_planes``,
``conv_dx_dw_fused``) within 1e-5 of the abs-sum form of their plain versions
(products of bf16 values are exact in f32, so only the order of the f32 sums
differs); ``pipelined`` bit-equal to not, the byte planes bit-equal to the bf16
table, and the fused backward's dw bit-equal across two runs.  On the bf16
route (``ops/conv.BF16_OPERANDS``): the gather-first conv with the eval-BN
epilogue within 1e-5 of ``abs-sum * |scale| + |shift|`` of its plain version,
the fused backward's dw alone bit-equal to its dw with dx, ``gather8`` on a
bf16-rounded table bit-equal to its plain version, ``scatter8`` on bf16-rounded
rows as the f32 one, neither allocating a bf16 copy, and no f32 conv,
backward, ``gather8``, ``child_sum`` or ``scatter8`` launch on the route.  The
child-sum chain (``child_sum``) is bit-equal to its plain version, the levels
run one after another, on both routes.  A chunk's batch plan replayed as a
CUDA graph (``runtime/prob_inference.PlanGraph``) is bit-equal to the eager
plan in every field, makes no synchronising call, and gives a fused round
the eager plans' probabilities, selection and launch counts.
"""

import copy
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from lidal_tpu_torch.active import lidal_runner
from lidal_tpu_torch.config import NU_CONFIG, SK_CONFIG, RunConfig
from lidal_tpu_torch.data.augment import AugmentDraws, sample_augment
from lidal_tpu_torch.data.pipeline import pad_points, prepare_eval_batch, prepare_train_batch
from lidal_tpu_torch.data.pipeline import forward_batch
from lidal_tpu_torch.data.selection import save_sv_info
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.ops import conv, cuda_conv, cuda_conv_bf16, cuda_conv_dxdw, cuda_conv_dxdw_fused, cuda_gather8, cuda_merge
from lidal_tpu_torch.ops.hashing import SENTINEL_KEY
from lidal_tpu_torch.ops.kernel_map import rulebook_streams
from lidal_tpu_torch.runtime import prob_inference
from lidal_tpu_torch.runtime.paths import Paths
from lidal_tpu_torch.runtime.train_loop import build_model
from lidal_tpu_torch.utils import profiling

CAPS = (1024, 512, 256, 128, 64)  # the coarse levels overflow on these frames


def launches(*kernels):
    """The launch counts of ``kernels`` (``launch.<kernel>`` in ``utils.profiling``)."""
    return tuple(profiling.counter("launch." + k) for k in kernels)


def _frames(seed, b=2, p=1024, n=900):
    """Surface-like frames (ground ring + walls) as CPU tensors xyz, sig, valid."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((b, p, 3), np.float32)
    for i in range(b):
        r = 0.5 + 6.0 * rng.random(n) ** 1.5
        th = rng.uniform(0, 2 * np.pi, n)
        z = np.where(rng.random(n) < 0.6, 0.05 * rng.standard_normal(n), rng.uniform(0, 1.5, n))
        xyz[i, :n] = np.stack([r * np.cos(th), r * np.sin(th), z], 1)
    valid = np.zeros((b, p), bool)
    valid[:, :n] = True
    return torch.from_numpy(xyz), torch.from_numpy(rng.random((b, p)).astype(np.float32)), torch.from_numpy(valid)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def plan_on(card):
    return prepare_eval_batch(None, *(t.to(card) for t in _frames(51)), level_caps=CAPS, augment=False)


def test_wrappers_refuse_devices_they_have_no_path_for():
    """A tensor that is on neither the CPU nor a CUDA card raises: there is no
    silent route to the plain version."""
    meta = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cuda_merge.lookup_sorted(meta, meta, meta, meta, with_found=True)
    f = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError):
        cuda_conv.subm_conv(f, torch.empty((27, 4, 32), device="meta"), torch.empty((8, 27), dtype=torch.int32, device="meta"))
    src = torch.empty((8, 32), device="meta")
    with pytest.raises(ValueError):
        cuda_conv_dxdw.conv_dx_dw(src, torch.empty((27, 32, 4), device="meta"),
                                  torch.empty((8, 27), dtype=torch.int32, device="meta"), f)
    nbr8, w8 = torch.empty((8, 8), dtype=torch.int32, device="meta"), torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError):
        cuda_gather8.gather8_forward(f, nbr8, w8)
    with pytest.raises(ValueError):
        cuda_gather8.scatter8(f, nbr8, w8, 8)
    w27, nbr27 = torch.empty((27, 32, 32), device="meta"), torch.empty((8, 27), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cuda_conv_bf16.conv_gather_first(src, w27, nbr27)
    with pytest.raises(ValueError):
        cuda_conv_bf16.conv_byte_planes(torch.empty((8, 64), dtype=torch.int8, device="meta"), w27, nbr27)
    with pytest.raises(ValueError):
        cuda_conv_dxdw_fused.conv_dx_dw_fused(src, w27, nbr27, src)


@pytest.mark.cuda
def test_lookup_kernel_matches_plain(plan_on):
    before = profiling.counter("launch.lookup_sorted")
    streams_by_level = [rulebook_streams(lv.coords, lv.valid) for lv in plan_on.plan.levels]
    t_hi, t_lo, q_hi, q_lo = streams_by_level[0]
    dup_hi, dup_lo = q_hi.clone(), q_lo.clone()
    dup_hi[:, 1::2], dup_lo[:, 1::2] = dup_hi[:, ::2], dup_lo[:, ::2]
    sent = torch.full_like(t_hi, SENTINEL_KEY)
    cases = streams_by_level + [
        (sent, sent, q_hi, q_lo),
        (t_hi, t_lo, torch.full_like(q_hi, SENTINEL_KEY), torch.full_like(q_lo, SENTINEL_KEY)),
        (t_hi, t_lo, dup_hi, dup_lo),
        (t_hi[:, :0].contiguous(), t_lo[:, :0].contiguous(), q_hi, q_lo),
    ]
    for streams in cases:
        for found in (True, False):
            got = cuda_merge.lookup_sorted(*streams, with_found=found)
            assert got.is_cuda
            assert torch.equal(got, cuda_merge.lookup_sorted_plain(*streams, with_found=found))
    assert profiling.counter("launch.lookup_sorted") == before + 2 * len(cases)


def _table_streams(keys, streams, dev):
    """(t_hi, t_lo, q_hi, q_lo) on ``dev`` from int64 keys: a table [T, n] and
    query streams [S, m]; (hi, lo) = (key // 2**16, key % 2**16 - 2**15) keeps
    the order, and the key -1 stands for the sentinel."""
    def pair(k):
        k = np.asarray(k, np.int64)
        hi = np.where(k < 0, SENTINEL_KEY, k // 2**16).astype(np.int32)
        lo = np.where(k < 0, SENTINEL_KEY, k % 2**16 - 2**15).astype(np.int32)
        return torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)
    return (*pair(keys), *pair(streams))


def _sentinel_tail(keys, tail):
    return np.concatenate([keys, np.full(keys.shape[:-1] + (tail,), -1, np.int64)], -1)


@pytest.mark.cuda
def test_lookup_kernel_window_branches(card):
    """The windowed lookup on streams built for each of its branches, both
    modes bit-equal to the plain version: a sorted offset stream with m not a
    multiple of the tile (every window in shared memory); an unsorted stream;
    one table searched by 26 streams; sparse queries, and a tile whose
    queries have one huge key gap, whose windows span far more table rows
    than the shared stage holds; a table with one huge key gap; all-sentinel
    tiles and tables."""
    rng = np.random.default_rng(9)
    ragged = 5 * 1024 + 37  # not a multiple of the kernel's 1024-query tile
    dense = np.sort(rng.choice(4 * ragged, ragged, replace=False)).astype(np.int64) * 3 + 100
    table = _sentinel_tail(dense[None], 500)
    offset = _sentinel_tail(np.sort(dense + 3 * rng.integers(-1, 2, ragged))[None], 300)
    unsorted = offset.copy()
    unsorted[0, :ragged] = rng.permutation(offset[0, :ragged])
    streams26 = _sentinel_tail(np.stack([np.sort(dense + 3 * d) for d in range(-13, 13)]), 500)
    big = np.sort(rng.choice(10**6, 40000, replace=False)).astype(np.int64)
    gapped = np.concatenate([big[:20000], big[20000:] + 10**10])
    cases = {  # name: (table keys, query streams, some tile takes the device-memory branch)
        "offset, ragged m": (table, offset, False),
        "unsorted": (table, unsorted, True),
        "T = 1, 26 streams": (table, streams26, False),
        "sparse queries": (big[None], _sentinel_tail((big[::16] + rng.integers(0, 2, 2500))[None], 7), True),
        "queries with one huge key gap": (big[None], np.concatenate([big[:512], big[-512:]])[None], True),
        "table with one huge key gap": (gapped[None], np.sort(np.concatenate(
            [gapped[19400:20600], 10**9 + np.arange(100)]))[None], False),
        "all-sentinel tiles": (table, np.full((2, 3000), -1, np.int64), False),
        "all-sentinel table": (np.full((1, 4096), -1, np.int64), offset, False),
    }
    before = profiling.counter("launch.lookup_sorted")
    for name, (tk, qk, wide) in cases.items():
        streams = _table_streams(tk, qk, card)
        for found in (True, False):
            got = cuda_merge.lookup_sorted(*streams, with_found=found)
            assert torch.equal(got, cuda_merge.lookup_sorted_plain(*streams, with_found=found)), (name, found)
        n_wide, n_tiles = cuda_merge.wide_tiles(*streams)
        assert (n_wide > 0) == wide and n_wide <= n_tiles, (name, n_wide, n_tiles)
    assert profiling.counter("launch.lookup_sorted") == before + 2 * len(cases)


def _conv_maps(plan_on):
    """{kind: (map [m, K] on the card, n)}: level 0's subm map, the down map
    (via ``child``), the up map (parents not monotonic) and an all-sentinel map."""
    lv0, d0 = plan_on.plan.levels[0], plan_on.plan.downs[0]
    b, cap0, _ = lv0.coords.shape
    cap1 = d0.child.shape[1]
    dev = plan_on.feats.device
    return {
        "subm": (conv._flatten_nbr(lv0.nbr3, cap0).to(dev), b * cap0),
        "down": (conv._flatten_nbr(d0.child, cap0).to(dev), b * cap0),
        "up": (conv._up_nbr(conv._flatten_idx(d0.parent, cap1), d0.pdelta.reshape(-1), 8, b * cap1).to(dev), b * cap1),
        "none": (torch.full((b * cap0, 27), b * cap0, dtype=torch.int32, device=dev), b * cap0),
    }


@pytest.mark.cuda
def test_conv_kernel_matches_plain(plan_on):
    rng = np.random.default_rng(5)
    maps = _conv_maps(plan_on)
    shapes = [("subm", 4, 32), ("subm", 32, 32), ("subm", 96, 96), ("subm", 384, 256),
              ("down", 128, 128), ("up", 256, 128), ("up", 96, 64)]
    before = profiling.counter("launch.subm_conv")
    for kind, cin, cout in shapes:
        nbr, n = maps[kind]
        feats, w, scale, shift = _conv_inputs(rng, n, nbr.shape[1], cin, cout, nbr.device)
        for ep in [(), (scale, shift, False), (scale, shift, True)]:
            want = cuda_conv.subm_conv_plain(feats, w, nbr, *ep)
            got = cuda_conv.subm_conv(feats, w, nbr, *ep)
            assert got.is_cuda and got.shape == want.shape
            assert bool(((got - want).abs() <= 1e-4 * want.abs().clamp_min(1.0)).all()), (kind, cin, cout, len(ep))
    assert profiling.counter("launch.subm_conv") == before + 3 * len(shapes)
    with pytest.raises(ValueError):  # a CUDA tensor the kernel cannot take raises; no fallback
        cuda_conv.subm_conv(feats.double(), w, nbr)


def _conv_inputs(rng, n, k, cin, cout, dev):
    """feats [n, cin], w [k, cin, cout], scale and shift [cout] on ``dev``."""
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)
    return (t(rng.standard_normal((n, cin))), t(rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)),
            t(rng.uniform(0.5, 1.5, cout)), t(rng.normal(size=cout)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cin,cout", [
    ("subm", 4, 32), ("subm", 12, 96), ("subm", 384, 256), ("down", 12, 256), ("down", 4, 96),
    ("up", 384, 32), ("up", 96, 96), ("none", 96, 256),
])
def test_conv_kernel_split_tf32_accuracy_and_reruns(plan_on, kind, cin, cout):
    """The split-TF32 tile at the stem's cin = 4, cin = 12 (a stage spans
    taps), 384 (12 stages a tap); cout 32, 96 and 256 (two column tiles); K =
    27 and 8; the up map; an all-sentinel map; each epilogue.  Within 1e-4 *
    max(1, |plain|) of the plain version, no further from the plain version
    in f64 than 4 x the f32 plain version is (+ 1e-6 of the abs-sum), and
    bit-equal on a rerun."""
    nbr, n = _conv_maps(plan_on)[kind]
    feats, w, scale, shift = _conv_inputs(np.random.default_rng(cin * cout), n, nbr.shape[1], cin, cout, nbr.device)
    ref = cuda_conv.subm_conv_plain(feats.double(), w.double(), nbr)
    abs_sum = cuda_conv.subm_conv_plain(feats.abs(), w.abs(), nbr)
    for ep in [(), (scale, shift, False), (scale, shift, True)]:
        got = cuda_conv.subm_conv(feats, w, nbr, *ep)
        want = cuda_conv.subm_conv_plain(feats, w, nbr, *ep)
        assert bool(((got - want).abs() <= 1e-4 * want.abs().clamp_min(1.0)).all()), len(ep)
        assert torch.equal(got, cuda_conv.subm_conv(feats, w, nbr, *ep)), "differs between two runs"
        if kind == "none":
            assert not got.any()
    got = cuda_conv.subm_conv(feats, w, nbr)
    e_k = float((got.double() - ref).abs().max())
    e_p = float((cuda_conv.subm_conv_plain(feats, w, nbr).double() - ref).abs().max())
    assert e_k <= 4.0 * e_p + 1e-6 * float(abs_sum.max()), (e_k, e_p)


def _scan_views(card):
    """Four consecutive frames of the round's scan traffic (``round_fused_r1``'s
    parameters, seed 7) at ``SK_CONFIG``'s caps on the card, as one eval batch:
    the shapes and maps of the benchmark's round and train cells."""
    import json

    from lidal_bench.traffic import scan

    mix = os.path.join(os.path.dirname(__file__), os.pardir, "lidal_bench", "traffic", "round_fused_r1.json")
    with open(mix) as fh:
        params = json.load(fh)["scan"]
    got, _ = scan.generate(7, 4, params, card)
    padded = [pad_points(xyz, inten, None, SK_CONFIG.point_cap) for xyz, inten, _ in got]
    xyz, sig, valid = (torch.as_tensor(np.stack([p[i] for p in padded])).to(card) for i in range(3))
    return prepare_eval_batch(None, xyz, sig, valid, level_caps=SK_CONFIG.level_caps, augment=False)


@pytest.mark.cuda
def test_row_order_keeps_the_f32_tiles_bits_at_the_cells_shapes(card, monkeypatch):
    """Every f32 conv shape of a MinkUNet train step on four scan frames at
    the benchmark's caps (each map with the plan's row order): with cin >= 32
    the forward with each epilogue and the backward's dx (and dwg) are
    bit-equal with and without the order; the stem's cin = 4 (a stage spans 8
    taps, so the order may regroup its sums) is within the kernel's gate
    against f64; every call is bit-equal on a rerun with the order."""
    eb = _scan_views(card)
    torch.manual_seed(0)
    model = MinkUNet(num_classes=19).to(card)
    fwd, bwd = {}, {}
    kernel_f, kernel_b = cuda_conv.subm_conv, cuda_conv_dxdw.conv_dx_dw

    def rec_f(feats, w, nbr, scale=None, shift=None, relu=False, *, order=None):
        key = (nbr.shape[1], feats.shape[1], w.shape[2], nbr.shape[0])
        fwd.setdefault(key, (feats.detach().clone(), w.detach().clone(), nbr, order))
        return kernel_f(feats, w, nbr, scale, shift, relu, order=order)

    def rec_b(src, w2, nbr, f, need_dx=True, *, order=None):
        if need_dx:
            key = (nbr.shape[1], src.shape[1], w2.shape[2], f.shape[1], nbr.shape[0])
            bwd.setdefault(key, (src.clone(), w2.clone(), nbr, f.detach().clone(), order))
        return kernel_b(src, w2, nbr, f, need_dx, order=order)

    monkeypatch.setattr(cuda_conv, "subm_conv", rec_f)
    monkeypatch.setattr(cuda_conv_dxdw, "conv_dx_dw", rec_b)
    logits, _ = model.train()(eb.feats, eb.plan)
    logits.square().mean().backward()
    monkeypatch.undo()
    assert len(fwd) >= 15 and len(bwd) >= 15 and {k[0] for k in fwd} == {27, 8}
    g = torch.Generator(device=card).manual_seed(1)
    for key, (feats, w, nbr, order) in fwd.items():
        assert order is not None and order.shape == (nbr.shape[0],), key
        cout = w.shape[2]
        scale, shift = torch.rand(cout, generator=g, device=card) + 0.5, torch.randn(cout, generator=g, device=card)
        for ep in [(), (scale, shift, False), (scale, shift, True)]:
            got = cuda_conv.subm_conv(feats, w, nbr, *ep, order=order)
            assert torch.equal(got, cuda_conv.subm_conv(feats, w, nbr, *ep, order=order)), (key, len(ep), "rerun")
            if feats.shape[1] >= 32:
                assert torch.equal(got, cuda_conv.subm_conv(feats, w, nbr, *ep)), (key, len(ep))
        if feats.shape[1] < 32:
            ref = cuda_conv.subm_conv_plain(feats.double(), w.double(), nbr)
            abs_sum = cuda_conv.subm_conv_plain(feats.abs(), w.abs(), nbr)
            e_k = float((cuda_conv.subm_conv(feats, w, nbr, order=order).double() - ref).abs().max())
            e_p = float((cuda_conv.subm_conv_plain(feats, w, nbr).double() - ref).abs().max())
            assert e_k <= 4.0 * e_p + 1e-6 * float(abs_sum.max()), (key, e_k, e_p)
    for key, (src, w2, nbr, f, order) in bwd.items():
        assert order is not None, key
        got = cuda_conv_dxdw.conv_dx_dw(src, w2, nbr, f, order=order)
        again = cuda_conv_dxdw.conv_dx_dw(src, w2, nbr, f, order=order)
        for a, b, c in zip(got, cuda_conv_dxdw.conv_dx_dw(src, w2, nbr, f), again):
            assert torch.equal(a, b) and torch.equal(a, c), key


@pytest.mark.cuda
def test_row_order_counter_counts_each_launch_that_walks_an_order(plan_on):
    """``conv.row_order`` counts every f32 forward and dx launch of a MinkUNet
    (all of them take their map's order): 42 a forward, 41 dx more a backward
    (the stem's input takes no gradient)."""
    torch.manual_seed(0)
    model = MinkUNet(num_classes=19).to(plan_on.feats.device)

    def counts():
        return launches("subm_conv", "conv_dx_dw") + (profiling.counter("conv.row_order"),)

    before = counts()
    with torch.inference_mode():
        model.eval()(plan_on.feats, plan_on.plan)
    assert tuple(a - b for a, b in zip(counts(), before)) == (42, 0, 42)
    before = counts()
    model.train()(plan_on.feats, plan_on.plan)[0].sum().backward()
    assert tuple(a - b for a, b in zip(counts(), before)) == (42, 42, 42 + 41)


@pytest.mark.cuda
def test_minkunet_kernel_path_matches_plain_path(plan_on, monkeypatch):
    torch.manual_seed(0)
    model = MinkUNet(num_classes=19).eval().to(plan_on.feats.device)
    with torch.inference_mode():
        logits, feat = model(plan_on.feats, plan_on.plan)
        monkeypatch.setattr(cuda_conv, "subm_conv", cuda_conv.subm_conv_plain)
        logits_p, feat_p = model(plan_on.feats, plan_on.plan)
    torch.testing.assert_close(feat, feat_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(logits, logits_p, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_conv_dx_dw_kernel_matches_plain_and_is_deterministic(plan_on):
    rng = np.random.default_rng(6)
    lv0, d0 = plan_on.plan.levels[0], plan_on.plan.downs[0]
    b, cap0, _ = lv0.coords.shape
    cap1 = d0.child.shape[1]
    dev = plan_on.feats.device
    # the backward maps: subm's own map; the down conv's up map (parents are
    # not monotonic); the up conv's child map; and a map that is all sentinel
    maps = {
        "subm": (conv._flatten_nbr(lv0.nbr3, cap0), b * cap0),
        "down": (conv._up_nbr(conv._flatten_idx(d0.parent, cap1), d0.pdelta.reshape(-1), 8, b * cap1), b * cap1),
        "up": (conv._flatten_nbr(d0.child, cap0), b * cap0),
        "none": (torch.full((b * cap0, 27), b * cap0, dtype=torch.int32), b * cap0),
    }
    shapes = [  # (map, c_src, c_dst, c_f, need_dx): the stem's first conv has c_f = 4 and no dx
        ("subm", 32, 4, 4, False), ("subm", 32, 32, 32, True), ("subm", 96, 128, 128, True),
        ("subm", 256, 384, 384, True), ("down", 64, 32, 32, True), ("up", 96, 128, 128, True),
        ("up", 256, 256, 256, True), ("none", 32, 32, 32, True),
    ]
    before = profiling.counter("launch.conv_dx_dw")
    for kind, c_src, c_dst, c_f, need_dx in shapes:
        nbr, n = maps[kind]
        nbr = nbr.to(dev)
        m, k = nbr.shape
        src = torch.from_numpy(rng.standard_normal((n, c_src)).astype(np.float32)).to(dev)
        w2 = torch.from_numpy((rng.standard_normal((k, c_src, c_dst)) / np.sqrt(k * c_src)).astype(np.float32)).to(dev)
        f = torch.from_numpy(rng.standard_normal((m, c_f)).astype(np.float32)).to(dev)
        dx, dwg = cuda_conv_dxdw.conv_dx_dw(src, w2, nbr, f, need_dx)
        dx2, dwg2 = cuda_conv_dxdw.conv_dx_dw(src, w2, nbr, f, need_dx)
        want_dx, want_dwg = cuda_conv_dxdw.conv_dx_dw_plain(src, w2, nbr, f, need_dx)
        _, bound = cuda_conv_dxdw.conv_dx_dw_plain(src.abs(), w2, nbr, f.abs(), need_dx=False)
        assert dwg.is_cuda and dwg.shape == (k, c_f, c_src)
        assert bool(((dwg - want_dwg).abs() <= 1e-4 * bound.clamp_min(1.0)).all()), (kind, c_src, c_f)
        assert torch.equal(dwg, dwg2), "dwg differs between two runs"
        if need_dx:
            assert bool(((dx - want_dx).abs() <= 1e-4 * want_dx.abs().clamp_min(1.0)).all()), (kind, c_src, c_dst)
            assert torch.equal(dx, dx2)
        else:
            assert dx is None and want_dx is None
        if kind == "none":
            assert not dwg.any() and not dx.any()
    assert profiling.counter("launch.conv_dx_dw") == before + 2 * len(shapes)
    with pytest.raises(ValueError):  # a CUDA tensor the kernel cannot take raises; no fallback
        cuda_conv_dxdw.conv_dx_dw(src.double(), w2, nbr, f)


def _dxdw_inputs(rng, m, n, k, c_src, c_dst, c_f, dev):
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)
    return (t(rng.standard_normal((n, c_src))), t(rng.standard_normal((k, c_src, c_dst)) / np.sqrt(k * c_src)),
            t(rng.standard_normal((m, c_f))))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty tap", "one pair", "stem", "unsorted and negative", "narrow c_f", "chunks"])
def test_conv_dx_dw_weight_gradient_edge_cases(card, case):
    """The dW half over per-tap pair lists: a tap that is all sentinel, a tap
    with one real pair, the stem's c_f = 4 with ``need_dx=False`` (src as the
    M operand, f in 8-column tiles), unsorted columns with negative and > n
    indices, c_f = 12 (two 8-column tiles, the second half empty) and taps of
    several chunks of pairs.  dwg within 1e-4 of plain_abs (the plain version
    on |src| and |f|), no further from the plain version in f64 than 4 x the
    f32 plain version (+ 1e-6 of plain_abs), bit-equal on a rerun; dx within
    1e-4 * max(1, |plain|)."""
    rng = np.random.default_rng(len(case))
    m, n, k, c_src, c_dst, c_f, need_dx = {
        "empty tap": (5000, 3000, 27, 64, 32, 64, True),
        "one pair": (700, 600, 8, 32, 32, 32, True),
        "stem": (20000, 20000, 27, 32, 4, 4, False),
        "unsorted and negative": (9000, 8000, 27, 96, 96, 96, True),
        "narrow c_f": (6000, 5000, 27, 64, 32, 12, False),
        "chunks": (300000, 200000, 8, 64, 64, 128, True),
    }[case]
    nbr = rng.integers(0, n, (m, k)).astype(np.int32)
    nbr[rng.random((m, k)) < 0.6] = n
    if case == "empty tap":
        nbr[:, 3] = n
    elif case == "one pair":
        nbr[:] = n
        nbr[417, 5] = 123
    elif case == "unsorted and negative":
        neg, big = rng.random((2, m, k)) < 0.1
        nbr[neg] = -rng.integers(1, 1 << 30, int(neg.sum()))
        nbr[big] = n + rng.integers(0, 1 << 30, int(big.sum()))
    nbr = torch.from_numpy(nbr).to(card)
    src, w2, f = _dxdw_inputs(rng, m, n, k, c_src, c_dst, c_f, card)
    dx, dwg = cuda_conv_dxdw.conv_dx_dw(src, w2, nbr, f, need_dx)
    _, dwg2 = cuda_conv_dxdw.conv_dx_dw(src, w2, nbr, f, need_dx)
    want_dx, want = cuda_conv_dxdw.conv_dx_dw_plain(src, w2, nbr, f, need_dx)
    _, ref = cuda_conv_dxdw.conv_dx_dw_plain(src.double(), w2.double(), nbr, f.double(), need_dx=False)
    _, bound = cuda_conv_dxdw.conv_dx_dw_plain(src.abs(), w2, nbr, f.abs(), need_dx=False)
    assert dwg.shape == (k, c_f, c_src) and bool(dwg.isfinite().all())
    assert bool(((dwg - want).abs() <= 1e-4 * bound).all()), float((dwg - want).abs().max())
    e_k = float((dwg.double() - ref).abs().max())
    e_p = float((want.double() - ref).abs().max())
    assert e_k <= 4.0 * e_p + 1e-6 * float(bound.max()), (e_k, e_p)
    assert torch.equal(dwg, dwg2), "dwg differs between two runs"
    if need_dx:
        assert bool(((dx - want_dx).abs() <= 1e-4 * want_dx.abs().clamp_min(1.0)).all())
    else:
        assert dx is None
    if case == "empty tap":
        assert not dwg[3].any() and dwg.abs().sum() > 0
    if case == "one pair":
        assert not dwg[torch.arange(k, device=card) != 5].any() and dwg[5].any()
    if case == "chunks":  # every tap's list spans several chunks of pairs
        counts = ((nbr >= 0) & (nbr < n)).sum(0)
        assert int(counts.min()) > cuda_conv_dxdw.pair_chunks(m, k, c_f, c_src)[1]


@pytest.mark.cuda
def test_train_step_backward_kernel_matches_plain(card, monkeypatch):
    """One train step's gradients with the backward kernel against the plain
    backward, under the same forward (the forward kernel is deterministic, so
    every ReLU mask is the same): each within 1e-4 of that gradient's max."""
    from lidal_tpu_torch.runtime.train import cross_entropy_ignore

    xyz, sig, valid = (t.to(card) for t in _frames(52))
    labels = torch.from_numpy(np.random.default_rng(7).integers(0, 19, valid.shape).astype(np.int32)).to(card)
    tb = prepare_train_batch(None, xyz, sig, valid, labels, level_caps=CAPS, augment=False)
    torch.manual_seed(0)
    model = MinkUNet(num_classes=19).to(card).train()
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def grads():
        model.load_state_dict(init)
        model.zero_grad(set_to_none=True)
        loss = cross_entropy_ignore(model(tb.feats, tb.plan)[0], tb.labels)
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}

    before = profiling.counter("launch.conv_dx_dw")
    loss, g = grads()
    assert profiling.counter("launch.conv_dx_dw") > before
    monkeypatch.setattr(cuda_conv_dxdw, "conv_dx_dw", cuda_conv_dxdw.conv_dx_dw_plain)
    loss_p, g_p = grads()
    assert loss == loss_p  # the same forward
    for name, want in g_p.items():
        assert bool(torch.isfinite(g[name]).all())
        assert float((g[name] - want).abs().max()) <= 1e-4 * max(float(want.abs().max()), 1e-30), name


def _registered_frames(seed, n_frames, n, extent=12.0):
    """Frames that see one static world from a moving origin, registered into
    one coordinate system (CPU tensors [n, 3]): neighbouring frames hold
    points within 0.1 m of each other."""
    rng = np.random.default_rng(seed)
    world = (rng.random((n, 3)) * np.array([extent, extent, 2.0]) - np.array([extent / 2, extent / 2, 1.0])).astype(np.float32)
    return [torch.from_numpy(world + rng.normal(scale=0.02, size=world.shape).astype(np.float32)) for _ in range(n_frames)]


@pytest.mark.cuda
def test_nn_band_kernel_matches_plain_bit_for_bit(card):
    """``d2`` and ``row`` of the kernel equal the plain version's on every
    query, matched or not: the kernel's sum is written without FMA contraction."""
    from lidal_tpu_torch.active import nn_match
    from lidal_tpu_torch.ops import cuda_nnband

    n, slots = 6000, 5
    frames = _registered_frames(61, slots + 1, n)
    valid = torch.ones(n, dtype=torch.bool)
    valid[n - 40 :] = False
    grids = nn_match.stack_grids([nn_match.build_grid(f.to(card), valid.to(card), 0.1) for f in frames[1:]])
    cpu_grids = nn_match.stack_grids([nn_match.build_grid(f, valid, 0.1) for f in frames[1:]])
    for a, b in zip(grids, cpu_grids):  # build_grid on the card == on the CPU, field by field
        assert torch.equal(a.cpu(), b)
    pq = nn_match.prepared_from_grid(nn_match.build_grid(frames[0].to(card), valid.to(card), 0.1))
    blo, nb = nn_match.band_bounds(grids, pq)
    before = profiling.counter("launch.nn_band")
    d2, row = cuda_nnband.nn_band(grids.planar, pq.q_t, blo, nb)
    assert profiling.counter("launch.nn_band") == before + 1 and d2.is_cuda
    d2_p, row_p = cuda_nnband.nn_band_plain(grids.planar, pq.q_t, blo, nb)
    assert torch.equal(d2, d2_p) and torch.equal(row, row_p)
    matched = (torch.sqrt(d2) <= torch.full((), 0.1, device=card)) & pq.s_ok
    assert 0.2 < float(matched.float().mean()) < 1.0
    # the same answer as the CPU's plain version on the CPU's grids
    pq_c = nn_match.prepared_from_grid(nn_match.build_grid(frames[0], valid, 0.1))
    d2_c, row_c = cuda_nnband.nn_band(cpu_grids.planar, pq_c.q_t, *nn_match.band_bounds(cpu_grids, pq_c))
    assert torch.equal(d2.cpu(), d2_c) and torch.equal(row.cpu(), row_c)
    with pytest.raises(ValueError):  # a CUDA tensor the kernel cannot take raises; no fallback
        cuda_nnband.nn_band(grids.planar.double(), pq.q_t, blo, nb)
    with pytest.raises(ValueError):
        cuda_nnband.nn_band(grids.planar, pq.q_t[:, :300].contiguous(), blo, nb)


@pytest.mark.cuda
def test_nn_band_kernel_edge_cases(card):
    """An empty band, a table of only BIG rows, an exact tie (lowest row wins)
    and a pair at 0.1 m -+ 1 ulp."""
    from lidal_tpu_torch.ops import cuda_nnband

    cap, p = 2048, 256
    tbl = torch.full((4, 3, cap), cuda_nnband.BIG_COORD)
    q = torch.zeros((3, p))
    tbl[1, :, 1030] = torch.tensor([0.05, 0.0, 0.0])
    tbl[1, :, 3] = torch.tensor([-0.05, 0.0, 0.0])
    tbl[1, :, 900] = torch.tensor([0.0, 0.05, 0.0])
    below, above = np.nextafter(np.float32(0.1), np.float32(0)), np.nextafter(np.float32(0.1), np.float32(1))
    tbl[2, 0, 5], tbl[2, 1:, 5] = float(below), 0.0
    tbl[3, 0, 5], tbl[3, 1:, 5] = float(above), 0.0
    blo = torch.zeros((4, 1), dtype=torch.int32)
    nb = torch.tensor([[0], [2], [1], [1]], dtype=torch.int32)
    args = [t.to(card) for t in (tbl, q, blo, nb)]
    d2, row = cuda_nnband.nn_band(*args)
    d2_p, row_p = cuda_nnband.nn_band_plain(*args)
    assert torch.equal(d2, d2_p) and torch.equal(row, row_p)
    assert bool(torch.isinf(d2[0]).all()) and not bool(row[0].any())
    assert int(row[1, 0]) == 3
    thresh = torch.full((), 0.1, device=card)
    assert bool(torch.sqrt(d2[2, 0]) <= thresh) and not bool(torch.sqrt(d2[3, 0]) <= thresh)
    big = [args[0][:1].contiguous(), args[1], args[2][:1].contiguous(), torch.full((1, 1), 2, dtype=torch.int32, device=card)]
    d2b, rowb = cuda_nnband.nn_band(*big)
    assert bool(torch.isfinite(d2b).all()) and not bool(rowb.any())
    assert torch.equal(d2b, cuda_nnband.nn_band_plain(*big)[0])


@pytest.mark.cuda
def test_nn_band_kernel_prunes_groups_exactly(card):
    """The pruned scan on registered frames whose bands span many groups:
    bit-equal to the plain version, fewer pairs evaluated than the bands hold,
    and a tie whose two rows lie in groups visited out of row order (the
    group of the higher row holds the query in its box, so it comes first)."""
    from lidal_tpu_torch.active import nn_match
    from lidal_tpu_torch.ops import cuda_nnband

    n, slots = 30000, 4
    frames = _registered_frames(62, slots + 1, n, extent=8.0)
    valid = torch.ones(n, dtype=torch.bool, device=card)
    grids = nn_match.stack_grids([nn_match.build_grid(f.to(card), valid, 0.1) for f in frames[1:]])
    pq = nn_match.prepared_from_grid(nn_match.build_grid(frames[0].to(card), valid, 0.1))
    blo, nb = nn_match.band_bounds(grids, pq)
    d2, row, pairs, needed = cuda_nnband.nn_band_counted(grids.planar, pq.q_t, blo, nb)
    d2_p, row_p = cuda_nnband.nn_band_plain(grids.planar, pq.q_t, blo, nb)
    assert torch.equal(d2, d2_p) and torch.equal(row, row_p)
    band_pairs = int(nb.long().sum()) * cuda_nnband.TN * cuda_nnband.TILE
    assert 0 < pairs < band_pairs and pairs % (cuda_nnband.GROUP * 32) == 0
    band_groups = nb.repeat_interleave(cuda_nnband.TILE, dim=1) * (cuda_nnband.TN // cuda_nnband.GROUP)
    assert bool((needed >= 0).all()) and bool((needed <= band_groups).all())
    assert int(needed.long().sum()) <= pairs // cuda_nnband.GROUP  # a lane's needed groups were scanned
    # the main-path launch gives the same answer
    assert all(torch.equal(a, b) for a, b in zip(cuda_nnband.nn_band(grids.planar, pq.q_t, blo, nb), (d2, row)))

    cap, p = 2048, 256
    tbl = torch.full((1, 3, cap), cuda_nnband.BIG_COORD)
    tbl[0, :, 0:32] = torch.tensor([0.3, 0.0, 0.0])[:, None]  # group 0: 32 rows at 0.3 m
    tbl[0, :, 1024:1056] = torch.tensor([0.35, 0.0, 0.0])[:, None]  # group 32: its box holds the query
    tbl[0, :, 1040] = torch.tensor([-0.3, 0.0, 0.0])
    args = [t.to(card) for t in (tbl, torch.zeros((3, p)), torch.zeros((1, 1), dtype=torch.int32),
                                 torch.full((1, 1), 2, dtype=torch.int32))]
    d2, row = cuda_nnband.nn_band(*args)
    assert torch.equal(d2, cuda_nnband.nn_band_plain(*args)[0]) and bool((row == 0).all())


@pytest.mark.cuda
def test_nn_band_and_build_grid_at_nuscenes_map_coordinates(card):
    """nuScenes registers frames into map coordinates of 10^2-10^3 m (here a
    world around (1500, 1650, 5) m, where an f32 coordinate's ulp is 1.2e-4 m):
    ``build_grid`` on the card equals the CPU's field by field, and ``nn_band``
    is bit-equal to its plain version on the card and on the CPU."""
    from lidal_tpu_torch.active import nn_match
    from lidal_tpu_torch.ops import cuda_nnband

    n, slots = 20000, 6
    origin = torch.tensor([1500.0, 1650.0, 5.0])
    frames = [f + origin for f in _registered_frames(63, slots + 1, n, extent=20.0)]
    assert float(frames[0][:, 1].max()) > 1650.0
    valid = torch.ones(n, dtype=torch.bool)
    valid[n - 100 :] = False
    on_card = [nn_match.build_grid(f.to(card), valid.to(card), 0.1) for f in frames]
    on_cpu = [nn_match.build_grid(f, valid, 0.1) for f in frames]
    for a, b in zip(on_card, on_cpu):
        for name, x, y in zip(b._fields, a, b):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y), name
    grids, cpu_grids = nn_match.stack_grids(on_card[1:]), nn_match.stack_grids(on_cpu[1:])
    pq, pq_c = nn_match.prepared_from_grid(on_card[0]), nn_match.prepared_from_grid(on_cpu[0])
    blo, nb = nn_match.band_bounds(grids, pq)
    d2, row = cuda_nnband.nn_band(grids.planar, pq.q_t, blo, nb)
    d2_p, row_p = cuda_nnband.nn_band_plain(grids.planar, pq.q_t, blo, nb)
    assert torch.equal(d2, d2_p) and torch.equal(row, row_p)
    d2_c, row_c = cuda_nnband.nn_band(cpu_grids.planar, pq_c.q_t, *nn_match.band_bounds(cpu_grids, pq_c))
    assert torch.equal(d2.cpu(), d2_c) and torch.equal(row.cpu(), row_c)
    matched = (torch.sqrt(d2) <= torch.full((), 0.1, device=card)) & pq.s_ok
    assert 0.2 < float(matched.float().mean()) < 1.0


def _random_map(rng, m, n, density=0.8):
    """[m, 8] targets in no order, duplicates within a row, all-sentinel rows, an
    index below 0 and one past the sentinel."""
    nbr = rng.integers(0, n, size=(m, 8)).astype(np.int32)
    nbr[rng.random((m, 8)) > density] = n
    nbr[::7, 3] = nbr[::7, 1]
    nbr[5::11] = n
    nbr[2, 0], nbr[3, 1] = -1, n + 5
    return torch.from_numpy(nbr)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,c", [(5000, 300, 256), (777, 2000, 128), (64, 64, 4), (300, 7, 1024)])
def test_gather8_kernel_bit_equal_to_plain(card, m, n, c):
    rng = np.random.default_rng(m)
    feats = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)).to(card)
    nbr = _random_map(rng, m, n).to(card)
    w8 = torch.from_numpy(rng.standard_normal((m, 8)).astype(np.float32)).to(card)
    before = profiling.counter("launch.gather8")
    got = cuda_gather8.gather8_forward(feats, nbr, w8)
    torch.cuda.synchronize()
    assert profiling.counter("launch.gather8") == before + 1
    assert torch.equal(got, cuda_gather8.gather8_plain(feats, nbr, w8))
    assert not got[5::11].any()  # all-sentinel rows are exactly zero
    with pytest.raises(ValueError):
        cuda_gather8.gather8_forward(feats[:, :3].contiguous(), nbr, w8)  # c % 4
    with pytest.raises(ValueError):
        cuda_gather8.gather8_forward(feats, nbr.long(), w8)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,c", [(20000, 40, 256), (5000, 3000, 128), (64, 64, 4), (300, 7, 1024)])
def test_scatter8_kernel_matches_plain_and_is_deterministic(card, m, n, c):
    rng = np.random.default_rng(n)
    dy = torch.from_numpy(rng.standard_normal((m, c)).astype(np.float32)).to(card)
    nbr = _random_map(rng, m, n).to(card)  # (20000, 40): 3200 pairs a target on average
    w8 = torch.from_numpy(rng.random((m, 8)).astype(np.float32)).to(card)
    before = profiling.counter("launch.scatter8")
    got = cuda_gather8.scatter8(dy, nbr, w8, n)
    torch.cuda.synchronize()
    assert profiling.counter("launch.scatter8") == before + 1
    assert torch.equal(got, cuda_gather8.scatter8(dy, nbr, w8, n))  # no atomics: the same bits
    plain = cuda_gather8.scatter8_plain(dy, nbr, w8, n)
    abs_sum = cuda_gather8.scatter8_plain(dy.abs(), nbr, w8.abs(), n)
    assert bool(((got - plain).abs() <= 1e-5 * abs_sum + 1e-12).all())
    ref = cuda_gather8.scatter8_plain(dy.double(), nbr, w8.double(), n)
    e_k, e_p = float((got.double() - ref).abs().max()), float((plain.double() - ref).abs().max())
    assert e_k <= 4.0 * e_p + 1e-6 * float(abs_sum.max())


def _edge_maps(rng):
    """Maps for the transposed-map kernels: random with duplicates and
    out-of-range targets, all sentinels, a row whose 8 taps share one
    target, and segments of ~3800 and of more than 2^16 pairs (both sorted
    by counting)."""
    maps = {"random": (_random_map(rng, 3000, 500), 500), "all sentinel": (torch.full((300, 8), 40, dtype=torch.int32), 40)}
    one = _random_map(rng, 200, 60)
    one[17] = 9
    maps["one row, one target"] = (one, 60)
    long = torch.from_numpy(rng.integers(-3, 50, size=(2000, 8)).astype(np.int32))
    long[rng.random((2000, 8)) < 0.19] = 7
    maps["long segment"] = (long, 50)
    past = torch.from_numpy(rng.integers(0, 10, size=(10000, 8)).astype(np.int32))
    past[:, 1:] = 3
    maps["segment past 2^16"] = (past, 10)  # 70,000+ pairs on target 3
    return maps


@pytest.mark.cuda
def test_scatter8_device_map_equals_build_transpose(card):
    rng = np.random.default_rng(17)
    for name, (nbr, n) in _edge_maps(rng).items():
        order, offsets = cuda_gather8.transpose_map(nbr.to(card), n)
        want_order, want_offsets = cuda_gather8.build_transpose(nbr, n)
        assert torch.equal(offsets.cpu(), want_offsets), name
        real = int(want_offsets[-1])
        assert torch.equal(order[:real].cpu(), want_order[:real]), name
    assert int(torch.diff(want_offsets).max()) > 2048  # the long segment is long


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,c,fan", [(40000, 20000, 128, 1), (20000, 2500, 256, 64), (4000, 20, 128, 1600)])
def test_scatter8_sum_kernel_within_tolerance_and_reruns(card, m, n, c, fan):
    """A warp per target (a few pairs a target, as the step's second call),
    segments of ~64 (the first call's longest) and segments split over the
    block's warps (1600 pairs a target)."""
    rng = np.random.default_rng(m + c)
    dy = torch.from_numpy(rng.standard_normal((m, c)).astype(np.float32)).to(card)
    base = np.minimum(np.arange(m)[:, None] * n // m + np.arange(8)[None, :] * (fan > 1), n - 1)
    nbr = np.where(rng.random((m, 8)) < 0.3 if fan == 1 else np.zeros((m, 8), bool), base, n).astype(np.int32)
    nbr = torch.from_numpy(nbr).to(card)
    w8 = torch.from_numpy(rng.random((m, 8)).astype(np.float32)).to(card)
    got = cuda_gather8.scatter8(dy, nbr, w8, n)
    assert torch.equal(got, cuda_gather8.scatter8(dy, nbr, w8, n))
    plain = cuda_gather8.scatter8_plain(dy, nbr, w8, n)
    abs_sum = cuda_gather8.scatter8_plain(dy.abs(), nbr, w8.abs(), n)
    assert bool(((got - plain).abs() <= 1e-5 * abs_sum + 1e-12).all())
    ref = cuda_gather8.scatter8_plain(dy.double(), nbr, w8.double(), n)
    e_k, e_p = float((got.double() - ref).abs().max()), float((plain.double() - ref).abs().max())
    assert e_k <= 4.0 * e_p + 1e-6 * float(abs_sum.max())


@pytest.mark.cuda
def test_gather8_function_backward_is_the_scatter_kernel(card):
    rng = np.random.default_rng(3)
    n, m, c = 500, 4000, 64
    feats = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)).to(card).requires_grad_(True)
    nbr, w8 = _random_map(rng, m, n).to(card), torch.rand((m, 8), device=card)
    cot = torch.randn((m, c), device=card)
    before = profiling.counter("launch.scatter8")
    (cuda_gather8.gather8(feats, nbr, w8) * cot).sum().backward()
    assert profiling.counter("launch.scatter8") == before + 1
    assert torch.equal(feats.grad, cuda_gather8.scatter8(cot, nbr, w8, n))


@pytest.mark.cuda
def test_spvcnn_kernel_path_matches_plain_path(card, monkeypatch):
    """Eval logits, and one train step's gradients, of a narrow SPVCNN: the
    point branch's and the backward's kernels against their plain versions.
    The conv forward stays the kernel's, so both runs see the same ReLU masks
    (``gather8`` is bit-equal to its plain version)."""
    torch.manual_seed(0)
    model = SPVCNN(num_classes=19, cs=(32, 32, 64, 64, 64, 64, 64, 32, 32)).to(card)
    xyz, sig, valid = (t.to(card) for t in _frames(53))
    labels = torch.randint(0, 19, valid.shape, dtype=torch.int32, device=card)
    tb = prepare_train_batch(None, xyz, sig, valid, labels, level_caps=CAPS, augment=False, with_points=True)

    def run():
        with torch.inference_mode():
            logits_eval = forward_batch(model.eval(), tb)[0]
        trained = copy.deepcopy(model).train()  # the train forward moves the BN statistics
        logits, _ = forward_batch(trained, tb, dropout_seeds=[1, 2])
        logits.square().mean().backward()
        return logits_eval, {n: p.grad.clone() for n, p in trained.named_parameters()}

    counts = launches("gather8", "scatter8", "child_sum")
    logits, grads = run()
    assert profiling.counter("launch.gather8") == counts[0] + 4  # 2 trilinear per forward, train and eval
    assert profiling.counter("launch.scatter8") == counts[1] + 2
    assert profiling.counter("launch.child_sum") == counts[2] + 4  # 2 chains per forward
    monkeypatch.setattr(cuda_conv_dxdw, "conv_dx_dw", cuda_conv_dxdw.conv_dx_dw_plain)
    monkeypatch.setattr(cuda_gather8, "gather8_forward", cuda_gather8.gather8_plain)
    monkeypatch.setattr(cuda_gather8, "child_sum", cuda_gather8.child_sum_plain)
    monkeypatch.setattr(cuda_gather8, "scatter8", cuda_gather8.scatter8_plain)
    logits_p, grads_p = run()
    assert torch.equal(logits, logits_p)
    for name, g in grads_p.items():
        if name.startswith("point_transforms.") and name.endswith(".0.bias"):
            # in front of a BN, which removes the mean: a zero gradient by construction, rounding noise in fact
            assert float(g.abs().max()) <= 1e-3 * float(grads_p[name.replace("bias", "weight")].abs().max()), name
            continue
        assert float((grads[name] - g).abs().max()) <= 1e-3 * max(float(g.abs().max()), 1e-6), name


def _probe_map(rng, m, n, k, density=0.8, sort=True):
    """[m, k] int32 map: banded columns (sorted when asked), sentinel n, and,
    when unsorted, an index below 0 and one past the sentinel."""
    cols = []
    for j in range(k):
        idx = np.arange(m) * n // m + (j - k // 2) * 3 + rng.integers(-5, 6, m)
        idx = np.where((idx < 0) | (idx >= n) | (rng.random(m) > density), n, idx)
        cols.append(np.sort(idx) if sort else rng.permutation(idx))
    nbr = np.stack(cols, 1).astype(np.int32)
    if not sort:
        nbr[2, 0], nbr[3, 1] = -1, n + 5
    return torch.from_numpy(nbr)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,cin,cout,sort", [
    (5000, 4000, 27, 4, 32, True), (3000, 3000, 27, 32, 32, True), (2500, 2500, 27, 96, 96, False),
    (777, 1500, 27, 256, 256, True), (4096, 512, 8, 128, 64, False), (64, 64, 27, 384, 128, True),
])
def test_gather_first_kernels_match_plain_and_each_other(card, m, n, k, cin, cout, sort):
    """K7 within 1e-5 of the abs-sum of its plain version; ``pipelined`` and
    the byte planes bit-equal to it; bit-equal across two runs."""
    rng = np.random.default_rng(m + cin)
    feats = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.standard_normal((k, cin, cout)) * 0.05).astype(np.float32)).to(card)
    nbr = _probe_map(rng, m, n, k, sort=sort).to(card)
    counts = launches("conv_gather_first", "conv_byte_planes")
    got = cuda_conv_bf16.conv_gather_first(feats, w, nbr)
    torch.cuda.synchronize()
    piped = cuda_conv_bf16.conv_gather_first(feats, w, nbr, pipelined=True)
    planes = cuda_conv_bf16.to_byte_planes(feats)
    from_planes = cuda_conv_bf16.conv_byte_planes(planes, w, nbr)
    assert launches("conv_gather_first", "conv_byte_planes") == (counts[0] + 2, counts[1] + 1)
    assert got.is_cuda and got.shape == (m, cout) and bool(got.isfinite().all())
    want = cuda_conv_bf16.conv_gather_first_plain(feats, w, nbr)
    abs_sum = cuda_conv_bf16.conv_gather_first_plain(feats.abs(), w.abs(), nbr)
    assert bool(((got - want).abs() <= 1e-5 * abs_sum).all()), float((got - want).abs().max())
    assert torch.equal(piped, got), "pipelined differs"
    assert torch.equal(from_planes, got), "byte planes differ"
    assert torch.equal(cuda_conv_bf16.conv_gather_first(feats, w, nbr), got)
    assert torch.equal(cuda_conv_bf16.conv_byte_planes_plain(planes, w, nbr), want)
    sentinel = torch.full_like(nbr, n)
    assert not cuda_conv_bf16.conv_gather_first(feats, w, sentinel, pipelined=True).any()
    assert not cuda_conv_bf16.conv_byte_planes(planes, w, sentinel).any()
    with pytest.raises(ValueError):  # a CUDA tensor the kernel cannot take raises; no fallback
        cuda_conv_bf16.conv_gather_first(feats.double(), w, nbr)
    with pytest.raises(ValueError):
        cuda_conv_bf16.conv_gather_first(feats, w[:, :, : cout - 8].contiguous(), nbr)  # cout % 32


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,c_src,c_dst,c_f,sort", [
    (512, 512, 8, 8, 8, 8, True), (9000, 7000, 27, 32, 4, 4, True), (6000, 6000, 27, 96, 128, 128, False),
    (3000, 2000, 27, 256, 384, 384, True), (5000, 700, 8, 64, 32, 96, False), (100, 300, 8, 128, 256, 64, True),
])
def test_fused_backward_kernel_matches_plain_in_its_three_modes(card, m, n, k, c_src, c_dst, c_f, sort):
    rng = np.random.default_rng(m + c_src)
    src = torch.from_numpy(rng.standard_normal((n, c_src)).astype(np.float32)).to(card)
    w2 = torch.from_numpy((rng.standard_normal((k, c_src, c_dst)) / np.sqrt(k * c_src)).astype(np.float32)).to(card)
    f = torch.from_numpy(rng.standard_normal((m, c_f)).astype(np.float32)).to(card)
    nbr = _probe_map(rng, m, n, k, sort=sort).to(card)
    before = profiling.counter("launch.conv_dx_dw_fused")
    dx, dw = cuda_conv_dxdw_fused.conv_dx_dw_fused(src, w2, nbr, f, "dx_dw")
    torch.cuda.synchronize()
    dx2, dw2 = cuda_conv_dxdw_fused.conv_dx_dw_fused(src, w2, nbr, f, "dx_dw")
    dx_a, none = cuda_conv_dxdw_fused.conv_dx_dw_fused(src, w2, nbr, f, "dx")
    dx_b, zeros = cuda_conv_dxdw_fused.conv_dx_dw_fused(src, w2, nbr, f, "dx_zero_dw")
    assert profiling.counter("launch.conv_dx_dw_fused") == before + 4
    want_dx, want_dw = cuda_conv_dxdw_fused.conv_dx_dw_fused_plain(src, w2, nbr, f)
    abs_dx, abs_dw = cuda_conv_dxdw_fused.conv_dx_dw_fused_plain(src.abs(), w2.abs(), nbr, f.abs())
    assert dx.shape == (m, c_dst) and dw.shape == (k, c_f, c_src) and dx.is_contiguous() and dw.is_contiguous()
    assert bool(dx.isfinite().all()) and bool(dw.isfinite().all())
    assert bool(((dx - want_dx).abs() <= 1e-5 * abs_dx).all()), float((dx - want_dx).abs().max())
    assert bool(((dx - want_dx).abs() <= 1e-5 * abs_dx).all()), float((dx - want_dx).abs().max())
    assert bool(((dw - want_dw).abs() <= 1e-5 * abs_dw).all()), float((dw - want_dw).abs().max())
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2), "two runs differ"
    assert none is None and torch.equal(dx_a, dx) and torch.equal(dx_b, dx)
    assert zeros.shape == dw.shape and not zeros.any()
    ref_dx, ref_dw = cuda_conv_dxdw.conv_dx_dw_plain(src.bfloat16().double(), w2.bfloat16().double(), nbr, f.bfloat16().double())
    for got, p, r, b in ((dx, want_dx, ref_dx, abs_dx), (dw, want_dw, ref_dw, abs_dw)):
        e_k, e_p = float((got.double() - r).abs().max()), float((p.double() - r).abs().max())
        assert e_k <= 4.0 * e_p + 1e-6 * float(b.max()), (e_k, e_p)
    with pytest.raises(ValueError):  # a CUDA tensor the kernel cannot take raises; no fallback
        cuda_conv_dxdw_fused.conv_dx_dw_fused(src.double(), w2, nbr, f)


def _edge_map(rng, case, m, n, k):
    """[m, k] int32 maps where the bf16 tiles are at risk: a tap with no real
    row, all sentinel, a down map (up to 8 real children a row), an up map
    (one real parent a row), an unsorted map with indices below 0 and past n."""
    nbr = rng.integers(0, n, (m, k)).astype(np.int32)
    if case == "up":
        nbr[:] = n
        nbr[np.arange(m), rng.integers(0, k, m)] = rng.integers(0, n, m)
        return torch.from_numpy(nbr)
    nbr[rng.random((m, k)) < {"down": 0.6, "sparse K=27": 0.96, "sparse down": 0.88}.get(case, 0.3)] = n
    if case == "empty tap":
        nbr[:, 5] = n
    elif case == "all sentinel":
        nbr[:] = n
    elif case == "unsorted":
        neg, big = rng.random((2, m, k)) < 0.05
        nbr[neg] = -rng.integers(1, 1 << 30, int(neg.sum()))
        nbr[big] = n + rng.integers(0, 1 << 30, int(big.sum()))
    return torch.from_numpy(nbr)


BF16_EDGE_CASES = {  # case: (m, n, k, cin = c_src, cout = c_dst, c_f)
    "stem": (4000, 3000, 27, 4, 32, 4),
    "cout 32": (2000, 2500, 27, 32, 32, 32),
    "wide": (700, 900, 27, 256, 384, 384),
    "ragged m": (128 * 7 + 77, 1000, 27, 96, 96, 96),
    "192-row tiles": (192 * 210 + 77, 30000, 27, 64, 128, 64),  # three warpgroups a tile, the last one ragged
    "sparse K=27": (20000 + 77, 30000, 27, 96, 96, 96),  # 4 % real, as at level 0 of a train step
    "sparse down": (6000, 20000, 8, 128, 128, 32),  # 12 % real
    "empty tap": (1500, 1500, 27, 64, 64, 64),
    "all sentinel": (1000, 800, 27, 96, 128, 96),
    "down": (3000, 20000, 8, 64, 128, 32),
    "up": (20000, 3000, 8, 128, 64, 128),
    "unsorted": (5000, 4000, 27, 32, 96, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BF16_EDGE_CASES))
def test_bf16_tiles_on_edge_maps(card, case):
    """The wgmma gather-first tile (``conv_gather_first``, its byte planes, and
    dx of ``conv_dx_dw_fused``) and the fused backward's per-tap pair-list dw
    at the widths and maps the tiling makes risky: within 1e-5 of the abs-sum
    of the plain versions, no further from f64 than 4 x the f32 plain version
    (+ 1e-6 of the abs-sum), ``pipelined`` and the planes bit-equal to the bf16
    table, every output bit-equal on a rerun, zeros where no pair is real."""
    m, n, k, cin, cout, c_f = BF16_EDGE_CASES[case]
    rng = np.random.default_rng(len(case) + m)
    nbr = _edge_map(rng, case, m, n, k).to(card)
    feats = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)).to(card)
    f = torch.from_numpy(rng.standard_normal((m, c_f)).astype(np.float32)).to(card)
    cb, fz = cuda_conv_bf16, cuda_conv_dxdw_fused
    assert (cb.tile_rows(cb.column_tile(cout), m, cout) == 192) == (case == "192-row tiles")
    got = cb.conv_gather_first(feats, w, nbr)
    torch.cuda.synchronize()
    want = cb.conv_gather_first_plain(feats, w, nbr)
    abs_sum = cb.conv_gather_first_plain(feats.abs(), w.abs(), nbr)
    assert got.shape == (m, cout) and bool(got.isfinite().all())
    assert bool(((got - want).abs() <= 1e-5 * abs_sum).all()), float((got - want).abs().max())
    assert torch.equal(cb.conv_gather_first(feats, w, nbr, pipelined=True), got)
    assert torch.equal(cb.conv_byte_planes(cb.to_byte_planes(feats), w, nbr), got)
    assert torch.equal(cb.conv_gather_first(feats, w, nbr), got)
    dx, dw = fz.conv_dx_dw_fused(feats, w, nbr, f, "dx_dw")
    torch.cuda.synchronize()
    if fz.padded_channels(cin, cout, c_f)[0] == cb.pack_table(feats).shape[1]:  # the same (tap, channel) stages
        assert torch.equal(dx, got), "dx is the gather-first tile's output"
    dx2, dw2 = fz.conv_dx_dw_fused(feats, w, nbr, f, "dx_dw")
    assert torch.equal(dx2, dx) and torch.equal(dw2, dw), "two runs differ"
    want_dx, want_dw = fz.conv_dx_dw_fused_plain(feats, w, nbr, f)
    abs_dx, abs_dw = fz.conv_dx_dw_fused_plain(feats.abs(), w.abs(), nbr, f.abs())
    assert dw.shape == (k, c_f, cin) and bool(dw.isfinite().all())
    assert bool(((dx - want_dx).abs() <= 1e-5 * abs_dx).all()), float((dx - want_dx).abs().max())
    assert bool(((dw - want_dw).abs() <= 1e-5 * abs_dw).all()), float((dw - want_dw).abs().max())
    ref_dx, ref_dw = cuda_conv_dxdw.conv_dx_dw_plain(feats.bfloat16().double(), w.bfloat16().double(), nbr,
                                                     f.bfloat16().double())
    for g, p, r, b in ((dx, want_dx, ref_dx, abs_dx), (dw, want_dw, ref_dw, abs_dw)):
        e_k, e_p = float((g.double() - r).abs().max()), float((p.double() - r).abs().max())
        assert e_k <= 4.0 * e_p + 1e-6 * float(b.max()), (e_k, e_p)
    if case == "all sentinel":
        assert not got.any() and not dw.any()
    if case == "empty tap":
        assert not dw[5].any() and dw.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", ["stem", "wide", "ragged m", "192-row tiles", "sparse K=27", "all sentinel", "down", "up",
                                  "unsorted"])
def test_bf16_epilogue_matches_plain_and_masks_empty_rows(card, case, relu):
    """The bf16 route's eval conv: ``conv_gather_first`` with the BN epilogue
    (``acc * scale + shift``, relu, 0 on rows with no real tap) within 1e-5 of
    ``abs-sum * |scale| + |shift|`` of its plain version, exact zeros on the
    empty rows, bit-equal on a rerun."""
    m, n, k, cin, cout, _ = BF16_EDGE_CASES[case]
    rng = np.random.default_rng(len(case) + m + relu)
    nbr = _edge_map(rng, case, m, n, k).to(card)
    feats = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)).to(card)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)).to(card)
    shift = torch.from_numpy(rng.normal(scale=0.1, size=cout).astype(np.float32)).to(card)
    cb = cuda_conv_bf16
    before = profiling.counter("launch.conv_gather_first")
    got = cb.conv_gather_first(feats, w, nbr, scale=scale, shift=shift, relu=relu)
    torch.cuda.synchronize()
    assert profiling.counter("launch.conv_gather_first") == before + 1
    want = cb.conv_gather_first_plain(feats, w, nbr, scale=scale, shift=shift, relu=relu)
    bound = cb.conv_gather_first_plain(feats.abs(), w.abs(), nbr) * scale.abs() + shift.abs()
    assert got.shape == (m, cout) and bool(got.isfinite().all())
    assert bool(((got - want).abs() <= 1e-5 * bound).all()), float((got - want).abs().max())
    empty = ~((nbr >= 0) & (nbr < n)).any(1)
    assert not got[empty].any() and (case != "all sentinel" or bool(empty.all()))
    if relu:
        assert bool((got >= 0).all())
    assert torch.equal(cb.conv_gather_first(feats, w, nbr, scale=scale, shift=shift, relu=relu), got)
    with pytest.raises(ValueError):  # the byte planes take no epilogue
        cb._launch(cb.to_byte_planes(feats), cb.pack_weights(w), nbr, True, False, scale, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stem", "sparse K=27", "down", "up", "all sentinel"])
def test_fused_backward_dw_alone_equals_dx_dw(card, case):
    """``need_dx=False`` (the stem's backward on the bf16 route) launches dw's
    kernels alone: dx is None and dw bit-equal to mode ``dx_dw``'s."""
    m, n, k, cin, cout, c_f = BF16_EDGE_CASES[case]
    rng = np.random.default_rng(len(case) + 3 * m)
    nbr = _edge_map(rng, case, m, n, k).to(card)
    src = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32)).to(card)
    w2 = torch.from_numpy((rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)).to(card)
    f = torch.from_numpy(rng.standard_normal((m, c_f)).astype(np.float32)).to(card)
    fz = cuda_conv_dxdw_fused
    before = profiling.counter("launch.conv_dx_dw_fused")
    dx, dw = fz.conv_dx_dw_fused(src, w2, nbr, f, "dx_dw", need_dx=False)
    torch.cuda.synchronize()
    assert dx is None and profiling.counter("launch.conv_dx_dw_fused") == before + 1
    _, dw_all = fz.conv_dx_dw_fused(src, w2, nbr, f, "dx_dw")
    assert torch.equal(dw, dw_all)
    want = fz.conv_dx_dw_fused_plain(src, w2, nbr, f, "dx_dw", need_dx=False)[1]
    bound = fz.conv_dx_dw_fused_plain(src.abs(), w2.abs(), nbr, f.abs(), "dx_dw", need_dx=False)[1]
    assert bool(((dw - want).abs() <= 1e-5 * bound).all())
    with pytest.raises(ValueError):
        fz.conv_dx_dw_fused(src, w2, nbr, f, "dx", need_dx=False)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,c", [(5000, 300, 256), (777, 2000, 128), (64, 64, 4), (300, 7, 1024)])
def test_bf16_gather8_and_scatter8_kernels_match_plain(card, m, n, c):
    """The bf16-row instances: ``gather8`` on a bf16-rounded table bit-equal
    to its plain version (the same rounded products and sums, in order);
    ``scatter8`` on bf16-rounded ``dy`` and ``w8`` within 1e-5 of
    ``sum |w8| |dy|`` per target and bit-equal across runs, and bit-equal to
    the f32 instance on rows rounded beforehand; each counts in its own
    counter."""
    rng = np.random.default_rng(m + c + 1)
    feats = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)).to(card)
    dy = torch.from_numpy(rng.standard_normal((m, c)).astype(np.float32)).to(card)
    nbr = _random_map(rng, m, n).to(card)
    w8 = torch.from_numpy(rng.random((m, 8)).astype(np.float32)).to(card)
    g8 = cuda_gather8
    counts = launches("gather8", "scatter8", "gather8_bf16", "scatter8_bf16")
    out = g8.gather8_forward(feats, nbr, w8, True)
    dfe = g8.scatter8(dy, nbr, w8, n, True)
    torch.cuda.synchronize()
    assert launches("gather8", "scatter8", "gather8_bf16", "scatter8_bf16") == (
        counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    assert torch.equal(out, g8.gather8_plain(feats, nbr, w8, True))
    assert not torch.equal(out, g8.gather8_forward(feats, nbr, w8))  # the table was rounded
    want = g8.scatter8_plain(dy, nbr, w8, n, True)
    bound = g8.scatter8_plain(dy.abs(), nbr, w8.abs(), n, True)
    assert bool(((dfe - want).abs() <= 1e-5 * bound).all()), float((dfe - want).abs().max())
    assert torch.equal(g8.scatter8(dy, nbr, w8, n, True), dfe)
    # rounding in registers gives the bits of the cast: the f32 kernels on rounded operands agree
    rounded = feats.bfloat16().float()
    assert torch.equal(out, g8.gather8_forward(rounded, nbr, w8))
    assert torch.equal(dfe, g8.scatter8(dy.bfloat16().float(), nbr, w8.bfloat16().float(), n))


def _allocations(fn) -> int:
    """Device allocations made while ``fn()`` runs."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["allocation.all.allocated"] - before


@pytest.mark.cuda
def test_route_wrappers_allocate_no_bf16_copy(card):
    """On the route ``gather8``, ``child_sum`` and ``scatter8`` allocate
    what the f32 instances do (the output, and ``scatter8``'s map scratch):
    no bf16 copy of the table, the points or ``dy``."""
    rng = np.random.default_rng(5)
    m, n, c = 4096, 512, 256
    feats = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)).to(card)
    dy = torch.from_numpy(rng.standard_normal((m, c)).astype(np.float32)).to(card)
    nbr = _random_map(rng, m, n).to(card)
    w8 = torch.from_numpy(rng.random((m, 8)).astype(np.float32)).to(card)
    x, children, counts = _chain_inputs(rng, (2, 600, 200, 70), c, card)
    for route in (False, True):
        assert _allocations(lambda: cuda_gather8.gather8_forward(feats, nbr, w8, route)) == 1
        assert _allocations(lambda: cuda_gather8.child_sum(x, children, counts, route)) == 1
        assert _allocations(lambda: cuda_gather8.scatter8(dy, nbr, w8, n, route)) == 2


def _chain_inputs(rng, shape, c, card):
    """x f32 [B, cap_0, c] with -0.0 rows, child maps [B, cap_{l+1}, 8] with
    sentinels, negative and out-of-range children, and counts: ``shape`` is
    (B, cap_0, cap_1, ...)."""
    b, caps = shape[0], shape[1:]
    x = rng.standard_normal((b, caps[0], c)).astype(np.float32)
    x[:, ::5] = -0.0
    children = []
    for l in range(len(caps) - 1):
        ch = rng.integers(0, caps[l], size=(b, caps[l + 1], 8)).astype(np.int32)
        ch[rng.random(ch.shape) > 0.5] = caps[l]
        ch[:, ::7] = caps[l]
        ch[0, 1, 2], ch[-1, 2, 3] = -1, caps[l] + 9
        children.append(torch.from_numpy(ch).to(card))
    counts = torch.from_numpy(rng.integers(0, 6, size=(b, caps[-1])).astype(np.int32)).to(card)
    return torch.from_numpy(x).to(card), children, counts


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape,c", [((2, 3000, 1000, 400, 150, 60), 256), ((3, 2000, 700, 250), 128),
                                     ((1, 64, 16), 4), ((2, 500, 200, 90), 512), ((4, 900, 300, 100, 40), 12)])
def test_child_sum_kernel_bit_equal_to_the_chain(card, shape, c, bf16):
    """The fused chain against its plain version (one ``gather8_plain`` a
    level, then the divide), bit for bit, sign of zero included, on a rerun
    too; it counts in its own counter.  A SPVCNN plan's chains below."""
    rng = np.random.default_rng(len(shape) + c)
    x, children, counts = _chain_inputs(rng, shape, c, card)
    before = launches("child_sum", "child_sum_bf16")
    got = cuda_gather8.child_sum(x, children, counts, bf16)
    torch.cuda.synchronize()
    after = launches("child_sum", "child_sum_bf16")
    assert after == (before[0] + (not bf16), before[1] + bf16)
    want = cuda_gather8.child_sum_plain(x, children, counts, bf16)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(cuda_gather8.child_sum(x, children, counts, bf16).view(torch.int32), got.view(torch.int32))
    with pytest.raises(ValueError):
        cuda_gather8.child_sum(x[..., :3].contiguous(), children, counts)  # c % 4
    with pytest.raises(ValueError):
        cuda_gather8.child_sum(x, [children[0].long()] + children[1:], counts)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_child_sum_kernel_on_a_spvcnn_plan(card, bf16, monkeypatch):
    """Both chains of a SPVCNN point plan through ``point_to_voxel_avg_batched``
    against the plain chain, bit for bit, forward and backward."""
    from lidal_tpu_torch.ops.devoxelize import point_to_voxel_avg_batched

    monkeypatch.setattr(conv, "BF16_OPERANDS", bf16)
    eb = prepare_eval_batch(None, *(t.to(card) for t in _frames(61)), level_caps=CAPS, augment=False, with_points=True)
    rng = np.random.default_rng(62)
    for name, levels in (("avg2", 2), ("avg4", 4)):
        x = torch.from_numpy(rng.standard_normal((2, CAPS[0], 128)).astype(np.float32)).to(card)
        x = (x * eb.plan.levels[0].valid[..., None]).requires_grad_(True)
        dy = torch.from_numpy(rng.standard_normal((2, CAPS[levels], 128)).astype(np.float32)).to(card)
        avg = getattr(eb.pplan, name)
        got = point_to_voxel_avg_batched(x, eb.plan.downs, avg, levels)
        (g,) = torch.autograd.grad(got, x, dy)
        with monkeypatch.context() as mp:
            mp.setattr(cuda_gather8, "child_sum", cuda_gather8.child_sum_plain)
            want = point_to_voxel_avg_batched(x, eb.plan.downs, avg, levels)
            (g_want,) = torch.autograd.grad(want, x, dy)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name
        assert torch.equal(g.view(torch.int32), g_want.view(torch.int32)), name
        assert bool((got != 0).any())


@pytest.mark.cuda
def test_bf16_route_launches_no_f32_kernel(card, monkeypatch):
    """Under ``conv.BF16_OPERANDS`` an eval
    forward of MinkUNet and one SPVCNN train step launch the bf16 kernels
    and none of the f32 conv, backward, gather8, child_sum or scatter8 kernels."""
    monkeypatch.setattr(conv, "BF16_OPERANDS", True)

    def counters():
        return launches("subm_conv", "conv_dx_dw", "gather8", "scatter8", "child_sum", "conv_gather_first",
                        "conv_dx_dw_fused", "gather8_bf16", "scatter8_bf16", "child_sum_bf16")

    torch.manual_seed(0)
    before = counters()
    eb = prepare_eval_batch(None, *(t.to(card) for t in _frames(53)), level_caps=CAPS, augment=False)
    with torch.inference_mode():
        logits, _ = MinkUNet(num_classes=19).eval().to(card)(eb.feats, eb.plan)
    mid = counters()
    assert mid[:5] == before[:5] and mid[5] - before[5] == 42 and mid[6:] == before[6:]
    assert bool(logits.isfinite().all()) and not logits[~eb.plan.levels[0].valid].any()
    xyz, sig, valid = (t.to(card) for t in _frames(54))
    labels = torch.randint(0, 19, valid.shape, generator=torch.Generator().manual_seed(1)).to(card)
    tb = prepare_train_batch(None, xyz, sig, valid, labels, level_caps=CAPS, augment=False, with_points=True)
    model = SPVCNN(num_classes=19, dropout_rate=0.0).to(card).train()
    logits, _ = forward_batch(model, tb)
    torch.nn.functional.cross_entropy(logits[tb.plan.levels[0].valid], tb.labels[tb.plan.levels[0].valid].long()).backward()
    torch.cuda.synchronize()
    after = counters()
    assert after[:5] == mid[:5], f"an f32 kernel launched on the bf16 route: {mid} -> {after}"
    assert after[5] - mid[5] == 42 and after[6] - mid[6] == 42
    assert (after[7] - mid[7], after[8] - mid[8], after[9] - mid[9]) == (2, 2, 2)
    assert all(bool(p.grad.isfinite().all()) for p in model.parameters() if p.grad is not None)


def _scan_points(rng, n):
    """n surface-like points of a street (a ground ring and walls), 2-42 m out."""
    r = 2.0 + 40.0 * rng.random(n) ** 1.5
    th = rng.uniform(0, 2 * np.pi, n)
    z = np.where(rng.random(n) < 0.6, -1.7 + 0.05 * rng.standard_normal(n), rng.uniform(-1.7, 2.0, n))
    return np.stack([r * np.cos(th), r * np.sin(th), z], 1).astype(np.float32)


def _fields(a, b, name="batch"):
    """(name, tensor of a, tensor of b) for every tensor of two batches of one structure."""
    if isinstance(a, torch.Tensor):
        return [(name, a, b)]
    if isinstance(a, tuple):
        names = getattr(a, "_fields", range(len(a)))
        assert type(a) is type(b) and len(a) == len(b), name
        return [f for n, x, y in zip(names, a, b) for f in _fields(x, y, f"{name}.{n}")]
    assert a is None and b is None, name
    return []


PLAN_DATA = {"SK": (SK_CONFIG, 110_000), "NU": (NU_CONFIG, 34_000)}  # caps, points a frame


@pytest.mark.cuda
@pytest.mark.parametrize("data_name", list(PLAN_DATA))
@pytest.mark.parametrize("augment", [True, False], ids=["augment", "plain"])
@pytest.mark.parametrize("with_points", [False, True], ids=["minkunet", "spvcnn"])
def test_plan_graph_replays_equal_eager_plans(card, data_name, augment, with_points):
    """Three frames of two chunks of 4 views through the chunk's plan graph:
    every field of every batch is bit-equal to the eager plan of the same
    inputs, and the first batch returned is unchanged after the later
    replays."""
    data, n = PLAN_DATA[data_name]
    key = (data.level_caps, data.scale, data.full_scale, augment, with_points)
    plan = prob_inference.chunk_plan(card, 4, data.point_cap, *key)
    eager = prob_inference.eager_plan(4, *key)
    assert isinstance(plan, prob_inference.PlanGraph)
    rng = np.random.default_rng(70)
    first = None
    with torch.inference_mode():
        for frame in range(3):
            m = n - n // 10 * frame
            xyz, sig, valid = (torch.from_numpy(a).to(card) for a in pad_points(
                _scan_points(rng, m), rng.random(m).astype(np.float32), None, data.point_cap)[:3])
            draws = sample_augment(prob_inference.frame_generator(5, frame), 8) if augment else None
            for c0 in (0, 4):
                rows = draws.rows(c0, c0 + 4) if augment else None
                got = plan(xyz, sig, valid, rows)
                want = eager(xyz, sig, valid, AugmentDraws(*(t.to(card) for t in rows)) if augment else None)
                for name, g, w in _fields(got, want):
                    assert g.dtype == w.dtype and torch.equal(g, w), f"frame {frame}, views {c0}-{c0 + 3}: {name}"
                if first is None:
                    first = (got, prob_inference._clone(got))
    assert plan.graph is not None
    for name, g, w in _fields(*first):
        assert torch.equal(g, w), f"the first batch's {name} changed under later replays"


@pytest.mark.cuda
@pytest.mark.parametrize("with_points", [False, True], ids=["minkunet", "spvcnn"])
def test_plan_and_its_replay_make_no_synchronising_call(card, with_points):
    """``prepare_eval_batch`` on device draws and a replayed chunk, under
    ``torch.cuda.set_sync_debug_mode("error")``: no call waits for the card."""
    data, n = PLAN_DATA["SK"]
    rng = np.random.default_rng(72)
    xyz, sig, valid = (torch.from_numpy(a).to(card) for a in pad_points(
        _scan_points(rng, n), rng.random(n).astype(np.float32), None, data.point_cap)[:3])
    draws = sample_augment(prob_inference.frame_generator(5, 0), 8)
    key = (data.level_caps, data.scale, data.full_scale, True, with_points)
    plan = prob_inference.chunk_plan(card, 4, data.point_cap, *key)
    with torch.inference_mode():
        plan(xyz, sig, valid, draws.rows(0, 4))  # captures where no earlier test did
        device_draws = AugmentDraws(*(t.to(card) for t in draws.rows(4, 8)))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prob_inference.eager_plan(4, *key)(xyz, sig, valid, device_draws)
            plan(xyz, sig, valid, draws.rows(4, 8))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def _round_tree(root, frames=6, n=20_000, k=20):
    """A SemanticKITTI sequence "00" of ``frames`` frames that see one static
    street from a sensor moving 0.5 m a frame, as the fused round reads it:
    the registered points, ``k`` supervoxels a frame and round-0 flags (the
    first frame labelled).  Returns (config, reader of the raw frames)."""
    rng = np.random.default_rng(71)
    world = _scan_points(rng, 3 * n)
    data = dataclasses.replace(SK_CONFIG, train_split=("00",), val_split=())
    cfg = RunConfig(dataset_name="SK", model_name="Mink", label_unit="sv", metric_name="LiDAL", r_id=1, seed=9,
                    inf_reps=8, view_chunk=4, data_root=str(root / "sequences"),
                    processing_root=str(root / "base"), checkpoint_root=str(root / "ckpt"), data_override=data)
    paths = Paths(cfg)
    dirs = [paths.grid_dir("00"), paths.supervoxel_dir("00", "KMeans"), paths.sv_flag_dir("00", r_id=0)]
    for d in dirs:
        os.makedirs(d)
    raw = {}
    for i in range(frames):
        name = f"{i:06d}"
        seen = np.sort(rng.choice(3 * n, n, replace=False))
        reg = world[seen] + 0.01 * rng.standard_normal((n, 3)).astype(np.float32)
        raw[name] = (reg - np.float32([0.5 * i, 0.0, 0.0]), rng.random(n).astype(np.float32))
        np.savez_compressed(os.path.join(dirs[0], f"{name}.npz"), xyz=reg)
        save_sv_info(os.path.join(dirs[1], f"{name}.npz"), rng.permutation(np.arange(n) % k),
                     np.arange(i * k, (i + 1) * k))
        np.save(os.path.join(dirs[2], f"{name}.npy"), np.full(k, int(i == 0), np.int32))
    return cfg, lambda seq, name: raw[name]


@pytest.mark.cuda
def test_fused_round_on_plan_graphs_equals_eager_plans(card, tmp_path, monkeypatch):
    """A fused round with every chunk's plan eager (``chunk_plan`` swapped),
    then twice on the plan graphs, from one tree: bit-equal probability
    maps, equal selections, and each kernel's launch count as eager's.  The
    first call captures the key once and replays 2 per frame less the first
    chunk (its eager warm-up); the second call replays 2 per frame."""
    monkeypatch.setattr(prob_inference, "_PLAN_GRAPHS", {})
    frames = 6
    cfg0, read_fn = _round_tree(tmp_path, frames)
    torch.manual_seed(0)
    model = build_model(cfg0).to(card).eval()

    def run(tag):
        cfg = dataclasses.replace(cfg0, processing_root=str(tmp_path / tag))
        shutil.copytree(cfg0.processing_root, cfg.processing_root)
        profiling.reset()
        res = lidal_runner.run_fused_lidal_round(cfg, model, read_fn, train_split=["00"],
                                                 train_point_num=frames * 20_000, device=card)
        counters = profiling.stats()["counters"]
        prob_dir = Paths(lidal_runner._prev_cfg(cfg)).prob_dir("00")
        probs = [np.load(os.path.join(prob_dir, f"{i:06d}.npy")) for i in range(frames)]
        return res, counters, probs

    with monkeypatch.context() as m:
        m.setattr(prob_inference, "chunk_plan",
                  lambda device, chunk, point_cap, *key: prob_inference.eager_plan(chunk, *key))
        eager = run("eager")
    first, second = run("graph_first"), run("graph_second")
    launches = {k: v for k, v in eager[1].items() if k.startswith("launch.")}
    assert launches["launch.lookup_sorted"] == 10 * frames and launches["launch.nn_band"] == frames
    assert not any(k.startswith("plan_graph.") for k in eager[1])
    for got, capture, replay in ((first, 1, 2 * frames - 1), (second, 0, 2 * frames)):
        res, counters, probs = got
        assert {k: v for k, v in counters.items() if k.startswith("launch.")} == launches
        assert counters.get("plan_graph.capture", 0) == capture and counters["plan_graph.replay"] == replay
        for i, (p, q) in enumerate(zip(probs, eager[2])):
            assert np.array_equal(p, q), f"frame {i}: probabilities differ from the eager plans'"
        for a, b in zip(res, eager[0]):
            assert np.array_equal(a, b), "the selection differs from the eager plans'"
