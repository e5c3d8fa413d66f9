"""The device-built transposed map of the ``scatter8`` kernel and its sum
order (``lidal_tpu_torch/csrc/gather8.cu``), emulated on the CPU.

The map kernels count each target's real pairs with integer atomics, scan the
counts into offsets, fill each real pair ``i * 8 + k`` into its target's
segment at a slot taken with an integer atomic (so the order inside a segment
is whatever order the atomics came in: drawn at random here), and sort each
segment: up to 512 ids, runs of 32 by rank, then runs merged pairwise, each
element placed by a binary search of the other run; longer, each id placed at
the count of smaller ids in its segment (by another kernel, the segment's
chunks spread over the grid).  The emulation must give exactly
``build_transpose``'s ``offsets`` and ``order[:offsets[n]]``, for any fill
order.

The sum kernel adds a target's pairs in blocks of 16 (a block's sum is added
to the total), 32 ids at a time, and splits a segment longer than 128 pairs
into 8 contiguous parts whose partials are added in order.  Emulated in f32
with every product and sum rounded on its own (the card may contract a
product and a sum into an FMA), it is held to ``scatter8_plain`` within
1e-5 of ``sum |w8| |dy|`` per target, the kernel's tolerance in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from lidal_tpu_torch.ops.cuda_gather8 import build_transpose, scatter8_plain

RUN = 32  # the sort's in-register run
SORT_CAP = 512  # longest segment sorted by merges in shared memory
BLOCK_SUM = 16
LONG_SEGMENT = 128
WARPS = 8


def _map_cases():
    rng = np.random.default_rng(7)
    cases = {}
    nbr = rng.integers(0, 300, size=(2000, 8)).astype(np.int32)
    nbr[rng.random((2000, 8)) > 0.7] = 300
    nbr[::7, 3] = nbr[::7, 1]  # duplicates within a row
    nbr[2, 0], nbr[3, 1], nbr[4, 2] = -1, 305, -(2**31)  # negative and out-of-range targets
    cases["random"] = (nbr, 300)
    cases["all_sentinel"] = (np.full((100, 8), 12, np.int32), 12)
    one = rng.integers(0, 40, size=(150, 8)).astype(np.int32)
    one[33] = 5  # all 8 taps of a row on one target
    cases["one_row_one_target"] = (one, 40)
    runs = rng.integers(0, 9, size=(600, 8)).astype(np.int32)  # segments of 2-20 runs of 32, odd counts too
    cases["several_runs"] = (runs, 9)
    long = rng.integers(-2, 30, size=(1500, 8)).astype(np.int32)
    long[rng.random((1500, 8)) < 0.3] = 11  # one segment of ~3600 pairs, past any in-register sort
    cases["long_segment"] = (long, 30)
    return cases


MAPS = _map_cases()


def device_map(nbr: np.ndarray, n: int, rng):
    """(order, offsets) as the count / scan / fill / sort kernels build them,
    the fill's atomics arriving in a random order."""
    flat = nbr.reshape(-1)
    real = np.flatnonzero((flat >= 0) & (flat < n))
    counts = np.bincount(flat[real], minlength=n).astype(np.int64)  # integer atomicAdd: any order, same counts
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    order = np.full(len(flat), -7, np.int32)  # past offsets[n]: scratch
    left = counts.copy()
    for pid in rng.permutation(real):  # atomicSub hands out the segment's slots from the top
        key = flat[pid]
        left[key] -= 1
        order[offsets[key] + left[key]] = pid
    assert not left.any()
    for t in range(n):
        seg = order[offsets[t] : offsets[t + 1]]
        order[offsets[t] : offsets[t + 1]] = sort_segment(seg) if len(seg) <= SORT_CAP else rank_segment(seg)
    return order, offsets


def rank_segment(seg: np.ndarray) -> np.ndarray:
    """map_rank_kernel on one segment: each id goes to the count of smaller ids."""
    out = np.empty_like(seg)
    for c0 in range(0, len(seg), 256):  # a block's chunk
        x = seg[c0 : c0 + 256]
        rank = np.zeros(len(x), np.int64)
        for s0 in range(0, len(seg), 2048):  # the tiles staged in shared memory
            rank += (seg[None, s0 : s0 + 2048] < x[:, None]).sum(1)
        out[rank] = x
    return out


def sort_segment(seg: np.ndarray) -> np.ndarray:
    """map_sort_kernel's merge sort on one segment of distinct ids (the
    kernel takes it up to SORT_CAP ids)."""
    seg = seg.copy()
    n = len(seg)
    for r0 in range(0, n, RUN):
        run = seg[r0 : r0 + RUN].copy()
        rank = (run[None, :] < run[:, None]).sum(1)  # each lane counts the smaller values of its run
        seg[r0 + rank] = run
    src, dst = seg, np.empty_like(seg)
    w = RUN
    while w < n:
        for i in range(n):
            v, run = src[i], i // w
            other0 = (run ^ 1) * w
            other = src[other0 : max(other0, min(other0 + w, n))]
            dst[(run & ~1) * w + (i - run * w) + int(np.searchsorted(other, v))] = v
        src, dst = dst, src
        w *= 2
    return src


@pytest.mark.parametrize("name", sorted(MAPS))
def test_device_map_equals_build_transpose_for_any_fill_order(name):
    nbr, n = MAPS[name]
    want_order, want_offsets = (a.numpy() for a in build_transpose(torch.from_numpy(nbr), n))
    for seed in range(3):
        order, offsets = device_map(nbr, n, np.random.default_rng(seed))
        np.testing.assert_array_equal(offsets, want_offsets)
        np.testing.assert_array_equal(order[: offsets[-1]], want_order[: want_offsets[-1]])
    fan = np.diff(offsets)
    if name == "long_segment":
        assert fan.max() > 2048
    if name == "all_sentinel":
        assert offsets[-1] == 0
    if name == "one_row_one_target":
        seg = order[offsets[5] : offsets[6]]
        assert set(range(33 * 8, 34 * 8)) <= set(seg.tolist())


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 65, 100, 257, 512, 1000])
def test_segment_sort_orders_runs_of_any_length(n):
    rng = np.random.default_rng(n)
    ids = rng.choice(10 * n + 10, size=n, replace=False).astype(np.int32)
    np.testing.assert_array_equal(sort_segment(ids), np.sort(ids))
    np.testing.assert_array_equal(rank_segment(ids), np.sort(ids))


def _segment_sum(dy, w_flat, seg, c):
    """One warp's sum over the ids ``seg``: blocks of 16 inside chunks of 32."""
    total = np.zeros(c, np.float32)
    for p0 in range(0, len(seg), 32):
        chunk = seg[p0 : p0 + 32]
        for h in range(0, len(chunk), BLOCK_SUM):
            blk = np.zeros(c, np.float32)
            for pid in chunk[h : h + BLOCK_SUM]:
                blk = blk + np.float32(w_flat[pid]) * dy[pid >> 3]
            total = total + blk
    return total


def sum_emulation(dy, nbr, w8, n):
    order, offsets = device_map(nbr, n, np.random.default_rng(0))
    w_flat = w8.reshape(-1)
    out = np.zeros((n, dy.shape[1]), np.float32)
    for t in range(n):
        seg = order[offsets[t] : offsets[t + 1]]
        if len(seg) <= LONG_SEGMENT:
            out[t] = _segment_sum(dy, w_flat, seg, dy.shape[1])
            continue
        length = len(seg)
        parts = [_segment_sum(dy, w_flat, seg[length * w // WARPS : length * (w + 1) // WARPS], dy.shape[1])
                 for w in range(WARPS)]
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        out[t] = acc
    return out


@pytest.mark.parametrize("name,c", [("random", 12), ("several_runs", 8), ("long_segment", 4), ("one_row_one_target", 36)])
def test_sum_order_within_tolerance_of_plain(name, c):
    nbr, n = MAPS[name]
    rng = np.random.default_rng(c)
    dy = rng.standard_normal((nbr.shape[0], c)).astype(np.float32)
    w8 = rng.random(nbr.shape).astype(np.float32)
    got = sum_emulation(dy, nbr, w8, n)
    args = (torch.from_numpy(dy), torch.from_numpy(nbr), torch.from_numpy(w8), n)
    want = scatter8_plain(*args).numpy()
    abs_sum = scatter8_plain(torch.from_numpy(np.abs(dy)), args[1], torch.from_numpy(np.abs(w8)), n).numpy()
    assert (np.abs(got - want) <= 1e-5 * abs_sum + 1e-12).all()
    ref = scatter8_plain(args[0].double(), args[1], args[2].double(), n).numpy()
    assert np.abs(got - ref).max() <= 4.0 * np.abs(want - ref).max() + 1e-6 * abs_sum.max()
