"""The row order of each map (``ops/kernel_map.row_order``) that the f32
gather-GEMM tile walks, on a frame of the benchmark's scan traffic
(``lidal_bench/traffic/scan.py`` with ``round_fused_r1.json``'s parameters,
seed 7, voxelized at 0.05 m under ``SK_CONFIG``'s caps): a stable
permutation, the tiles' fill it gives (``kernel_map.tile_fill``), the plain
convs' outputs with and without it, and which order each conv of a MinkUNet
step hands to the kernel wrappers."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from lidal_bench.traffic import scan
from lidal_tpu_torch.config import SK_CONFIG
from lidal_tpu_torch.data.pipeline import pad_points, prepare_eval_batch, prepare_train_batch
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.ops import cuda_conv, cuda_conv_dxdw, kernel_map
from lidal_tpu_torch.ops.conv import _flatten_idx, _flatten_nbr, _up_nbr
from lidal_tpu_torch.runtime.train import cross_entropy_ignore

ROUND_MIX = os.path.join(os.path.dirname(__file__), os.pardir, "lidal_bench", "traffic", "round_fused_r1.json")
SMALL_CAPS = (16384, 8192, 4096, 2048, 1024)
NARROW = (8, 8, 16, 16, 32, 32, 16, 16, 16)  # tests/test_torch_minkunet.py's


@pytest.fixture(scope="module")
def frames():
    with open(ROUND_MIX) as fh:
        params = json.load(fh)["scan"]
    got, _ = scan.generate(7, 2, params, "cpu")
    padded = [pad_points(xyz, inten, lab.astype(np.int32) % 20, SK_CONFIG.point_cap) for xyz, inten, lab in got]
    return [torch.as_tensor(np.stack([p[i] for p in padded])) for i in range(4)]  # xyz, sig, valid, labels


@pytest.fixture(scope="module")
def plan(frames):
    xyz, sig, valid, _ = frames
    return prepare_eval_batch(None, xyz[:1], sig[:1], valid[:1], level_caps=SK_CONFIG.level_caps,
                              augment=False).plan


def _maps(plan):
    """(name, flattened map [m, K], its sentinel, the plan's order) of every map of the plan."""
    out = []
    for l, lv in enumerate(plan.levels):
        cap = lv.coords.shape[1]
        out.append((f"subm{l}", _flatten_nbr(lv.nbr3, cap), lv.coords.shape[0] * cap, lv.order))
    for l, d in enumerate(plan.downs):
        b, cap_f = d.parent.shape
        cap_c = d.child.shape[1]
        up = _up_nbr(_flatten_idx(d.parent, cap_c), d.pdelta.reshape(-1), kernel_map.K2, b * cap_c)
        out.append((f"down{l}", _flatten_nbr(d.child, cap_f), b * cap_f, d.child_order))
        out.append((f"up{l}", up, b * cap_c, d.up_order))
    return out


def _keys(nbr, n):
    real = ((nbr >= 0) & (nbr < n)).numpy().astype(np.int64)
    return (real << np.arange(nbr.shape[1])).sum(1)


def test_each_order_is_the_stable_mask_sort_of_its_map(plan):
    """A permutation of the flattened rows whose tap masks do not rise, rows
    with equal masks in row order (numpy's stable sort as the yardstick)."""
    maps = _maps(plan)
    assert len(maps) == 13
    for name, nbr, n, order in maps:
        assert order.dtype == torch.int32 and order.numel() == nbr.shape[0], name
        got = order.reshape(-1).numpy()
        keys = _keys(nbr, n)
        np.testing.assert_array_equal(got, np.argsort(-keys, kind="stable"), err_msg=name)
        assert (np.diff(keys[got]) <= 0).all(), name


def test_orders_are_the_same_on_a_rebuilt_plan(frames, plan):
    xyz, sig, valid, _ = frames
    again = prepare_eval_batch(None, xyz[:1], sig[:1], valid[:1], level_caps=SK_CONFIG.level_caps,
                               augment=False).plan
    for (name, _, _, a), (_, _, _, b) in zip(_maps(plan), _maps(again)):
        assert torch.equal(a, b), name


def test_tile_fill_rises_with_the_order(plan):
    """Level 0's subm map at 64-row tiles, and every up map, before and after."""
    fills = {name: (kernel_map.tile_fill(nbr, None, 64, n), kernel_map.tile_fill(nbr, order, 64, n))
             for name, nbr, n, order in _maps(plan)}
    before, after = fills["subm0"]
    assert before <= 0.40 and after >= 0.60, fills["subm0"]
    for l in range(len(plan.downs)):
        assert fills[f"up{l}"][1] >= 0.85, (l, fills[f"up{l}"])
    assert all(a > b for b, a in fills.values()), fills


def test_tile_fill_counts_what_a_tile_multiplies():
    """Two 2-row tiles: rows (tap 0), (taps 0, 1) then (tap 2), (none):
    4 real pairs of 2 x 2 + 2 x 1 products."""
    n = 5
    nbr = torch.tensor([[0, n, n], [1, 2, n], [n, n, 3], [n, n, n]], dtype=torch.int32)
    assert kernel_map.tile_fill(nbr, None, 2, n) == pytest.approx(4 / 6)
    order = torch.tensor([0, 2, 1, 3], dtype=torch.int32)  # tiles of taps {0, 2} and {0, 1}
    assert kernel_map.tile_fill(nbr, order, 2, n) == pytest.approx(4 / 8)
    assert kernel_map.tile_fill(nbr, None, 3, n) == pytest.approx(4 / 9)  # the padded last tile has no real tap


def test_plain_convs_equal_with_and_without_the_order(plan):
    g = torch.Generator().manual_seed(3)
    for name, nbr, n, order in _maps(plan)[2:]:  # levels 2-4 and the maps after them: small enough
        k = nbr.shape[1]
        feats = torch.randn((n, 8), generator=g)
        w = torch.randn((k, 8, 32), generator=g)
        scale, shift = torch.randn(32, generator=g), torch.randn(32, generator=g)
        flat = order.reshape(-1)
        assert torch.equal(cuda_conv.subm_conv(feats, w, nbr, scale, shift, True, order=flat),
                           cuda_conv.subm_conv(feats, w, nbr, scale, shift, True)), name
        m = nbr.shape[0]
        dy = torch.randn((n, 32), generator=g)
        w2 = torch.randn((k, 32, 8), generator=g)
        f = torch.randn((m, 8), generator=g)
        got = cuda_conv_dxdw.conv_dx_dw(dy, w2, nbr, f, order=flat)
        for a, b in zip(got, cuda_conv_dxdw.conv_dx_dw(dy, w2, nbr, f)):
            assert torch.equal(a, b), name


def _recording(calls):
    """Stand-ins for the two f32 wrappers that record (kind, K, whether the
    order passed is the order of the map passed) and run the plain versions."""

    def check(kind, nbr, n, order):
        want = kernel_map.row_order(((nbr >= 0) & (nbr < n))[None]).reshape(-1)
        calls.append((kind, nbr.shape[1], order is not None and torch.equal(order, want)))

    def fwd(feats, w, nbr, scale=None, shift=None, relu=False, *, order=None):
        check("fwd", nbr, feats.shape[0], order)
        return cuda_conv.subm_conv_plain(feats, w, nbr, scale, shift, relu)

    def bwd(src, w2, nbr, f, need_dx=True, *, order=None):
        check("dx" if need_dx else "dw", nbr, src.shape[0], order)
        return cuda_conv_dxdw.conv_dx_dw_plain(src, w2, nbr, f, need_dx)

    return fwd, bwd


@pytest.mark.parametrize("train", [True, False])
def test_every_conv_of_a_minkunet_passes_its_maps_order(monkeypatch, frames, train):
    """Two frames at small caps, so the rows of the second frame are offset:
    each f32 conv call (forward, eval epilogue or backward) gets the order
    of the map it walks."""
    xyz, sig, valid, labels = frames
    torch.manual_seed(0)
    model = MinkUNet(num_classes=20, cs=NARROW)
    calls = []
    fwd, bwd = _recording(calls)
    monkeypatch.setattr(cuda_conv, "subm_conv", fwd)
    monkeypatch.setattr(cuda_conv_dxdw, "conv_dx_dw", bwd)
    if train:
        tb = prepare_train_batch(None, xyz, sig, valid, labels, level_caps=SMALL_CAPS, augment=False)
        logits, _ = model.train()(tb.feats, tb.plan)
        cross_entropy_ignore(logits, tb.labels).backward()
    else:
        eb = prepare_eval_batch(None, xyz, sig, valid, level_caps=SMALL_CAPS, augment=False)
        with torch.no_grad():
            model.eval()(eb.feats, eb.plan)
    fwd_calls = [c for c in calls if c[0] == "fwd"]
    assert len(fwd_calls) == 42 and {c[1] for c in fwd_calls} == {27, 8}
    if train:
        assert sum(c[0] == "dx" for c in calls) == 41 and sum(c[0] == "dw" for c in calls) == 1
    assert all(ok for _, _, ok in calls), [c for c in calls if not c[2]]
