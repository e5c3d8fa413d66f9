"""The frozen work arithmetic against brute-force counts on tiny maps."""

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from lidal_bench import work
from lidal_bench.metrics_common import share
from lidal_bench.reference import data as rdata
from lidal_bench.reference.model import Maps, build

CS = (8, 8, 16, 16, 24, 24, 16, 8, 8)


def _tiny_map(seed, m=40, n=30, k=27):
    g = np.random.default_rng(seed)
    nbr = g.integers(-2, n + 3, (m, k))
    return torch.from_numpy(nbr.astype(np.int32)), n


def test_conv_counts_equal_brute_force():
    nbr, n = _tiny_map(1)
    feats, w, out = torch.zeros(n, 12), torch.zeros(27, 12, 20), torch.zeros(40, 20)
    pairs = sum(1 for v in nbr.flatten().tolist() if 0 <= v < n)
    rows = len({v for v in nbr.flatten().tolist() if 0 <= v < n})
    ops, moved = work.conv_fwd_work(feats, w, nbr, out)
    assert float(ops) == 2.0 * pairs * 12 * 20
    assert float(moved) == 4.0 * rows * 12 + 4 * (w.numel() + nbr.numel() + out.numel())
    f = torch.zeros(40, 7)
    dx, dwg = torch.zeros(n, 5), torch.zeros(27, 12, 7)
    w2 = torch.zeros(27, 12, 5)
    rows_with_tap = sum(1 for r in nbr.tolist() if any(0 <= v < n for v in r))
    ops, moved = work.conv_bwd_work(feats, w2, nbr, f, True, dx, dwg)
    assert float(ops) == 2.0 * pairs * 12 * (5 + 7)
    assert float(moved) == 4.0 * rows * 12 + 4.0 * rows_with_tap * 7 + 4 * (w2.numel() + nbr.numel() + dx.numel() + dwg.numel())
    ops, _ = work.conv_bwd_work(feats, w2, nbr, f, False, None, dwg)
    assert float(ops) == 2.0 * pairs * 12 * 7


def test_child_sum_counts_equal_brute_force():
    g = np.random.default_rng(3)
    caps = [50, 20, 8]
    children = [torch.from_numpy(g.integers(-1, caps[l] + 2, (2, caps[l + 1], 8)).astype(np.int32)) for l in range(2)]
    counts = torch.zeros(2, caps[2], dtype=torch.int32)
    x, out = torch.zeros(2, caps[0], 4), torch.zeros(2, caps[2], 4)
    adds = node_rows = 0
    points = 0
    for b in range(2):
        reached = set(range(caps[2]))
        for level in (1, 0):
            node_rows += len(reached)
            nxt = set()
            for o in reached:
                for v in children[level][b, o].tolist():
                    if 0 <= v < caps[level]:
                        adds += 4
                        nxt.add(v)
            reached = nxt
        points += len(reached)
    ops, moved = work.child_sum_work(x, children, counts, out)
    assert float(ops) == adds + counts.numel() * 4
    assert float(moved) == 32.0 * node_rows + 4.0 * points * 4 + 4 * (counts.numel() + out.numel())


def _tiny_frames(seed, b=2):
    g = np.random.default_rng(seed)
    frames = []
    for _ in range(b):
        pts = np.concatenate([g.integers(0, 60, (400, 3)), g.integers(0, 6, (200, 3)) * 4 + 30])
        frames.append(rdata.build_frame(torch.from_numpy(pts), [256, 128, 64, 32, 16]))
    return frames


def test_level_counts_equal_brute_force():
    fr = _tiny_frames(5, 1)[0]
    rows, subm, down = rdata.level_counts(fr)
    for l, lv in enumerate(fr.levels):
        cells = set(map(tuple, lv.coords.tolist()))
        assert rows[l] == len(cells)
        want = sum(1 for c in cells for d in rdata.OFFSETS3.tolist() if tuple(np.add(c, d)) in cells)
        assert subm[l] == want
        if l + 1 < len(fr.levels):
            coarse = set(map(tuple, fr.levels[l + 1].coords.tolist()))
            assert down[l] == sum(1 for c in cells if tuple(np.right_shift(c, 1)) in coarse)


def test_train_flops_equal_the_reference_models_counted_flops():
    """``pass_flops`` against torch's FLOP counter over a forward and backward
    of the plain reference model, whose convs multiply only real pairs."""
    frames = _tiny_frames(7)
    for spvcnn in (False, True):
        torch.manual_seed(0)
        model = build(spvcnn, 5, CS, 4)
        mp = Maps(frames)
        feats = torch.randn(mp.n[0], 4)
        counter = FlopCounterMode(display=False)
        with counter:
            args = (list(range(len(frames))), [256, 128, 64, 32, 16]) if spvcnn else ()
            logits = model(feats, mp, frames, *args)
            logits.square().sum().backward()
        rows = [sum(rdata.level_counts(f)[0][l] for f in frames) for l in range(5)]
        subm = [sum(rdata.level_counts(f)[1][l] for f in frames) for l in range(5)]
        down = [sum(rdata.level_counts(f)[2][l] for f in frames) for l in range(4)]
        want = work.pass_flops(work.unet_layers(CS, 4, 5, spvcnn), rows, subm, down, train=True)
        assert counter.get_total_flops() == want


def test_share_of_a_known_bound_and_time():
    # 3.35e9 bytes at 3.35e12 B/s: 1 ms; 495e9 operations at 495e12: 1 ms; either bound
    rec = {"calls": {"g": [(495e9, 1.0, 4e-3), (1.0, 3.35e9, 4e-3)]}}
    assert abs(share(rec, "g") - 25.0) < 1e-9
    assert share(rec, "other") is None
    b = work.Bound()
    assert b.add(3.35e9, 0.0) == 1e-3 and b.by == "bytes"
