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
the plain backward's, under one forward.
"""

import numpy as np
import pytest
import torch

from lidal_tpu_torch.data.pipeline import prepare_eval_batch, prepare_train_batch
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.ops import conv, cuda_conv, cuda_conv_dxdw, cuda_merge
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
