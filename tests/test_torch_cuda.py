"""The port's CUDA kernels against their plain versions, on the card.

This module imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)  Without a
card the ``cuda`` tests skip; the device check itself runs everywhere.

Tolerances: lookups are bit-equal; a conv output and the backward's dx within
1e-4 * max(1, |plain|) (f32 sums of up to 27 * 384 products in another order,
no TF32); the backward's dwg within 1e-4 * max(1, plain_abs), where plain_abs
is the plain version on |src| and |f| (a reordered f32 sum over every row);
a forward's logits within 1e-4 on these small frames; a train step's
gradients with the backward kernel within 1e-4 of each gradient's max of
the plain backward's, under one forward.  ``gather8`` is bit-equal to its
plain version (the same products and sums in the same order, no FMA);
``scatter8`` within 1e-5 of ``sum |w8| |dy|`` per target of its plain version
(``index_add_``, atomics in no fixed order on a card), no further from the plain
version in f64 than 4 times the f32 plain version is, and bit-equal across
two runs.
"""

import copy

import numpy as np
import pytest
import torch

from lidal_tpu_torch.data.pipeline import prepare_eval_batch, prepare_train_batch
from lidal_tpu_torch.data.pipeline import forward_batch
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.ops import conv, cuda_conv, cuda_conv_dxdw, cuda_gather8, cuda_merge
from lidal_tpu_torch.ops.hashing import SENTINEL_KEY
from lidal_tpu_torch.ops.kernel_map import rulebook_streams

CAPS = (1024, 512, 256, 128, 64)  # the coarse levels overflow on these frames


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


@pytest.mark.cuda
def test_lookup_kernel_matches_plain(plan_on):
    before = cuda_merge.LAUNCHES
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
    assert cuda_merge.LAUNCHES == before + 2 * len(cases)


@pytest.mark.cuda
def test_conv_kernel_matches_plain(plan_on):
    rng = np.random.default_rng(5)
    lv0, d0 = plan_on.plan.levels[0], plan_on.plan.downs[0]
    b, cap0, _ = lv0.coords.shape
    cap1 = d0.child.shape[1]
    maps = {
        "subm": (conv._flatten_nbr(lv0.nbr3, cap0), b * cap0),
        "down": (conv._flatten_nbr(d0.child, cap0), b * cap0),
        "up": (conv._up_nbr(conv._flatten_idx(d0.parent, cap1), d0.pdelta.reshape(-1), 8, b * cap1), b * cap1),
    }
    shapes = [("subm", 4, 32), ("subm", 32, 32), ("subm", 96, 96), ("subm", 384, 256),
              ("down", 128, 128), ("up", 256, 128), ("up", 96, 64)]
    before = cuda_conv.LAUNCHES
    for kind, cin, cout in shapes:
        nbr, n = maps[kind]
        nbr = nbr.to(plan_on.feats.device)
        k = nbr.shape[1]
        feats = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32)).to(nbr.device)
        w = torch.from_numpy((rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)).to(nbr.device)
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)).to(nbr.device)
        shift = torch.from_numpy(rng.normal(size=cout).astype(np.float32)).to(nbr.device)
        for ep in [(), (scale, shift, False), (scale, shift, True)]:
            want = cuda_conv.subm_conv_plain(feats, w, nbr, *ep)
            got = cuda_conv.subm_conv(feats, w, nbr, *ep)
            assert got.is_cuda and got.shape == want.shape
            assert bool(((got - want).abs() <= 1e-4 * want.abs().clamp_min(1.0)).all()), (kind, cin, cout, len(ep))
    assert cuda_conv.LAUNCHES == before + 3 * len(shapes)
    with pytest.raises(ValueError):  # a CUDA tensor the kernel cannot take raises; no fallback
        cuda_conv.subm_conv(feats.double(), w, nbr)


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
    before = cuda_conv_dxdw.LAUNCHES
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
    assert cuda_conv_dxdw.LAUNCHES == before + 2 * len(shapes)
    with pytest.raises(ValueError):  # a CUDA tensor the kernel cannot take raises; no fallback
        cuda_conv_dxdw.conv_dx_dw(src.double(), w2, nbr, f)


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

    before = cuda_conv_dxdw.LAUNCHES
    loss, g = grads()
    assert cuda_conv_dxdw.LAUNCHES > before
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
    before = cuda_nnband.LAUNCHES
    d2, row = cuda_nnband.nn_band(grids.planar, pq.q_t, blo, nb)
    assert cuda_nnband.LAUNCHES == before + 1 and d2.is_cuda
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
    before = cuda_gather8.GATHER8_LAUNCHES
    got = cuda_gather8.gather8_forward(feats, nbr, w8)
    torch.cuda.synchronize()
    assert cuda_gather8.GATHER8_LAUNCHES == before + 1
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
    before = cuda_gather8.SCATTER8_LAUNCHES
    got = cuda_gather8.scatter8(dy, nbr, w8, n)
    torch.cuda.synchronize()
    assert cuda_gather8.SCATTER8_LAUNCHES == before + 1
    assert torch.equal(got, cuda_gather8.scatter8(dy, nbr, w8, n))  # no atomics: the same bits
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
    before = cuda_gather8.SCATTER8_LAUNCHES
    (cuda_gather8.gather8(feats, nbr, w8) * cot).sum().backward()
    assert cuda_gather8.SCATTER8_LAUNCHES == before + 1
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

    counts = cuda_gather8.GATHER8_LAUNCHES, cuda_gather8.SCATTER8_LAUNCHES
    logits, grads = run()
    assert cuda_gather8.GATHER8_LAUNCHES == counts[0] + 16  # 8 per forward, train and eval
    assert cuda_gather8.SCATTER8_LAUNCHES == counts[1] + 2
    monkeypatch.setattr(cuda_conv_dxdw, "conv_dx_dw", cuda_conv_dxdw.conv_dx_dw_plain)
    monkeypatch.setattr(cuda_gather8, "gather8_forward", cuda_gather8.gather8_plain)
    monkeypatch.setattr(cuda_gather8, "scatter8", cuda_gather8.scatter8_plain)
    logits_p, grads_p = run()
    assert torch.equal(logits, logits_p)
    for name, g in grads_p.items():
        if name.startswith("point_transforms.") and name.endswith(".0.bias"):
            # in front of a BN, which removes the mean: a zero gradient by construction, rounding noise in fact
            assert float(g.abs().max()) <= 1e-3 * float(grads_p[name.replace("bias", "weight")].abs().max()), name
            continue
        assert float((grads[name] - g).abs().max()) <= 1e-3 * max(float(g.abs().max()), 1e-6), name
