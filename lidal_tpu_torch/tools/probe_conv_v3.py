"""A/B probe: the gather-first bf16 conv kernel, unpipelined and pipelined,
against the f32 gather-GEMM conv kernel (port of ``tools/probe_conv_v3.py``).

    python -m lidal_tpu_torch.tools.probe_conv_v3 [--device cuda]

Variant A (``prod``): ``ops/cuda_conv.subm_conv``, f32, gathers and contracts
tap by tap.

Variant B (gather-first): ``ops/cuda_conv_bf16.conv_gather_first``: operands
rounded to bf16, the rows of a group of taps assembled in shared memory first,
then ONE contraction per (tile, group, channel chunk) on the tensor cores.

Variant C (B + pipelined): the next stage is copied in with ``cp.async`` while
this one is contracted; the values are bit-equal to B's.

Per shape it checks B and C against the f32 plain version on the same inputs
(max error below 3 % of the largest output: bf16 operands), that C equals B bit
for bit, and prints the three times.  The maps and data are those of the JAX
probe: the same generator, seed and order of draws.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lidal_tpu_torch.ops import cuda_conv, cuda_conv_bf16
from lidal_tpu_torch.tools.timing import device_time

# (n = m, cin, cout, label): the conv shapes of a SemanticKITTI MinkUNet level by level
SHAPES = (
    (131072, 4, 32, "stem1"),
    (131072, 32, 32, "stem2"),
    (131072, 96, 96, "dec-L0"),
    (49152, 96, 96, "dec-L1"),
    (16384, 128, 128, "enc-L2"),
    (6144, 256, 256, "enc-L3"),
)
BF16_TOL = 0.03


def make_nbr(rng, n, k, rows_per_x):
    """Banded synthetic rulebook [n, k], every column sorted, sentinel n."""
    base = np.arange(n)
    cols = []
    for kk in range(k):
        xoff = kk // (k // 3) - 1 if k == 27 else kk // 4
        shift = xoff * rows_per_x + (kk % 9) - 4
        idx = base + shift + rng.integers(-40, 40, n)
        bad = (idx < 0) | (idx >= n) | (rng.random(n) < 0.12)
        idx = np.where(bad, n, idx)
        idx.sort()
        cols.append(idx)
    return np.stack(cols, 1).astype(np.int32)


def main(device="cuda", shapes=None, iters: int = 20):
    """Run the probe on ``device`` (``shapes`` defaults to ``SHAPES``); returns
    one dict of readings per shape."""
    shapes = SHAPES if shapes is None else shapes
    rng = np.random.default_rng(0)
    rows = []
    for n, cin, cout, label in shapes:
        nbr = torch.from_numpy(make_nbr(rng, n, 27, max(300, n // 40))).to(device)
        feats = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32)).to(device)
        w = torch.from_numpy((rng.standard_normal((27, cin, cout)) * 0.05).astype(np.float32)).to(device)

        # correctness vs the f32 plain version (bf16 tolerances)
        ref = cuda_conv.subm_conv_plain(feats, w, nbr)
        got_b = cuda_conv_bf16.conv_gather_first(feats, w, nbr, pipelined=False)
        got_c = cuda_conv_bf16.conv_gather_first(feats, w, nbr, pipelined=True)
        scale = float(ref.abs().max()) + 1e-9
        for name, got in (("B", got_b), ("C", got_c)):
            err = float((got - ref).abs().max()) / scale
            assert err < BF16_TOL, (label, name, err)
        assert torch.equal(got_b, got_c), (label, "pipelined differs from unpipelined")

        args = (feats, w, nbr)
        ms_a = device_time(cuda_conv.subm_conv, args, iters=iters)
        ms_b = device_time(lambda f, ww, nb: cuda_conv_bf16.conv_gather_first(f, ww, nb, pipelined=False), args, iters=iters)
        ms_c = device_time(lambda f, ww, nb: cuda_conv_bf16.conv_gather_first(f, ww, nb, pipelined=True), args, iters=iters)
        print(
            f"{label:8s} n={n:6d} c{cin:3d}->c{cout:3d}  prod {ms_a:6.2f}  "
            f"gather-first {ms_b:6.2f}  +pipelined {ms_c:6.2f} ms",
            flush=True,
        )
        rows.append({"label": label, "n": n, "cin": cin, "cout": cout, "prod_ms": ms_a,
                     "gather_first_ms": ms_b, "pipelined_ms": ms_c})
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
