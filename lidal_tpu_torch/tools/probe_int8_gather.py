"""Probe: the EXACT byte-plane gather for the gather-first conv kernel (port of
``tools/probe_int8_gather.py``).

    python -m lidal_tpu_torch.tools.probe_int8_gather [--device cuda]

The bf16 feature table is re-encoded as two int8 byte planes ([n, 2 * cin_pad]:
low bytes, then high bytes of the bit patterns), and each gathered value is
rebuilt bit for bit on its way into shared memory:

    bits = ((hi & 0xFF) << 8) | (lo & 0xFF)          # the bf16 bit pattern

No quantization anywhere: a lossless re-encoding of the gather.  On the TPU
the planes let a one-hot "gather" matmul run at the int8 rate.  A GPU gathers
by address, so that question has no counterpart here; what this probe reads on
the card is what two 1-byte-plane row reads cost against one 2-byte row read.

It compares ``conv_byte_planes`` with ``conv_gather_first`` (the bf16 table)
for (a) bitwise output parity and (b) device time, both on operands packed
once outside the timed loop.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lidal_tpu_torch.ops import cuda_conv_bf16
from lidal_tpu_torch.tools.timing import device_time

N = 131072
SHAPES = ((96, 96), (32, 32))  # (cin, cout)


def make_nbr(rng, n, k, rows_per_x):
    """Banded synthetic rulebook shaped like a real frame's."""
    base = np.arange(n, dtype=np.int64)
    cols = []
    for j in range(k):
        off = (j // 9 - 1) * rows_per_x + (j % 9 - 4) * max(1, rows_per_x // 18)
        idx = base + off + rng.integers(-3, 4, n)
        idx = np.where((idx < 0) | (idx >= n) | (rng.random(n) < 0.25), n, idx)
        cols.append(np.sort(idx))
    return np.stack(cols, 1).astype(np.int32)


def main(device="cuda", n=None, shapes=None, iters: int = 20):
    """Run the probe on ``device`` (``n`` and ``shapes`` default to ``N`` and
    ``SHAPES``); returns one dict of readings per shape."""
    n = N if n is None else n
    shapes = SHAPES if shapes is None else shapes
    rng = np.random.default_rng(0)
    rows = []
    for cin, cout in shapes:
        feats = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32)).to(device)
        w = torch.from_numpy((0.1 * rng.standard_normal((27, cin, cout))).astype(np.float32)).to(device)
        nbr = torch.from_numpy(make_nbr(rng, n, 27, max(300, n // 40))).to(device)
        planes = cuda_conv_bf16.to_byte_planes(feats)

        ref = cuda_conv_bf16.conv_gather_first(feats, w, nbr)
        got = cuda_conv_bf16.conv_byte_planes(planes, w, nbr)
        diff = float((ref - got).abs().max())
        print(f"c{cin}->{cout}: max |ref - i8| = {diff:g} (bitwise={torch.equal(ref, got)})", flush=True)
        assert torch.equal(ref, got), (cin, cout, diff)

        if torch.device(device).type == "cuda":  # the kernels alone, on operands packed once
            table, wt = cuda_conv_bf16.pack_table(feats), cuda_conv_bf16.pack_weights(w)
            t_ref = device_time(cuda_conv_bf16.gather_first_packed, (table, wt, nbr), iters=iters)
            t_i8 = device_time(cuda_conv_bf16.byte_planes_packed, (planes, wt, nbr), iters=iters)
        else:
            t_ref = device_time(cuda_conv_bf16.conv_gather_first, (feats, w, nbr), iters=iters)
            t_i8 = device_time(cuda_conv_bf16.conv_byte_planes, (planes, w, nbr), iters=iters)
        print(f"c{cin}->{cout}: bf16 {t_ref:.2f} ms  int8-bytes {t_i8:.2f} ms", flush=True)
        rows.append({"cin": cin, "cout": cout, "max_abs_diff": diff, "bf16_ms": t_ref, "planes_ms": t_i8})
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
