"""The port's CUDA kernels against their plain versions, on the card.

This module imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.)  Without a
card the ``cuda`` tests skip; the device check itself runs everywhere.

Tolerances: lookups are bit-equal; a conv output within 1e-4 * max(1, |plain|)
(f32 sums of up to 27 * 384 products in another order, no TF32); a forward's
logits within 1e-4 on these small frames.
"""

import numpy as np
import pytest
import torch

from lidal_tpu_torch.data.pipeline import prepare_eval_batch
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.ops import conv, cuda_conv, cuda_merge
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
