"""Feature probe of the fused conv backward: what the gather, the weight-gradient
product and the ``f`` operand each cost (port of ``tools/probe_dxdw_features.py``).

    python -m lidal_tpu_torch.tools.probe_dxdw_features [--device cuda]

The JAX probe added the features of the backward kernel to the forward
kernel's structure one at a time, to find which one its compiler hung on.
Here the same three steps are the three modes of
``ops/cuda_conv_dxdw_fused.conv_dx_dw_fused``, each checked against the plain
version and timed:

    A  fwd-only                      mode "dx":         the gather and dx
    B  + revisited dw out (zeros)    mode "dx_zero_dw": a second output, all zeros
    C  + dw math, carry, RMW         mode "dx_dw":      the f operand and dw

at the probe's own shape (n = m = 512, c = 8, K = 8: the JAX probe's map and
data, same generator, seed and order of draws) and at the largest and the
widest conv of a B = 5 SemanticKITTI train step, on banded synthetic maps.
The f32 ``conv_dx_dw`` kernel, which gathers once per product, is timed beside
them.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lidal_tpu_torch.ops import cuda_conv_dxdw, cuda_conv_dxdw_fused
from lidal_tpu_torch.tools.probe_int8_gather import make_nbr
from lidal_tpu_torch.tools.timing import device_time

TOL = 1e-5  # share of the abs-sum form of the plain version: only the order of the f32 sums differs
# (label, m = n, K, c_src, c_dst, c_f) beside the probe's own shape
STEP_SHAPES = (
    ("largest (level 0)", 5 * 131072, 27, 96, 96, 96),
    ("widest (level 3)", 5 * 6144, 27, 256, 384, 384),
)
VARIANTS = (("A fwd-only", "dx"), ("B + revisited dw out (zeros)", "dx_zero_dw"), ("C + dw math, carry, RMW", "dx_dw"))


def probe_inputs(rng):
    """The JAX probe's map and operands: n = m = 512, c = 8, K = 8."""
    n = m = 512
    c = k = 8
    nbr = np.full((m, k), n, np.int32)
    for j in range(k):
        rows = np.sort(rng.choice(m, size=400, replace=False))
        vals = np.sort(rng.choice(n, size=400, replace=False))
        nbr[rows, j] = vals
    src = rng.standard_normal((n, 128)).astype(np.float32)[:, :c]
    w2 = rng.standard_normal((k, c, c)).astype(np.float32)
    f = rng.standard_normal((m, c)).astype(np.float32)
    return np.ascontiguousarray(src), w2, nbr, f


def step_inputs(rng, m, k, c_src, c_dst, c_f):
    nbr = make_nbr(rng, m, k, max(300, m // 40))
    src = rng.standard_normal((m, c_src), dtype=np.float32)
    w2 = (rng.standard_normal((k, c_src, c_dst), dtype=np.float32) / np.sqrt(k * c_src)).astype(np.float32)
    f = rng.standard_normal((m, c_f), dtype=np.float32)
    return src, w2, nbr, f


def _run(label, arrays, device, iters):
    src, w2, nbr, f = (torch.from_numpy(a).to(device) for a in arrays)
    want_dx, want_dw = cuda_conv_dxdw_fused.conv_dx_dw_fused_plain(src, w2, nbr, f)
    abs_dx, abs_dw = cuda_conv_dxdw_fused.conv_dx_dw_fused_plain(src.abs(), w2.abs(), nbr, f.abs())
    row = {"label": label, "m": nbr.shape[0], "k": nbr.shape[1], "c_src": src.shape[1], "c_dst": w2.shape[2],
           "c_f": f.shape[1]}
    print(f"{label}: m=n={nbr.shape[0]} K={nbr.shape[1]} c_src={src.shape[1]} c_dst={w2.shape[2]} c_f={f.shape[1]}", flush=True)
    for name, mode in VARIANTS:
        dx, dw = cuda_conv_dxdw_fused.conv_dx_dw_fused(src, w2, nbr, f, mode)
        assert bool(((dx - want_dx).abs() <= TOL * abs_dx).all()), (label, name, "dx")
        if mode == "dx":
            assert dw is None, (label, name)
        elif mode == "dx_zero_dw":
            assert dw.shape == want_dw.shape and not bool(dw.any()), (label, name, "dw must be zeros")
        else:
            assert bool(((dw - want_dw).abs() <= TOL * abs_dw).all()), (label, name, "dw")
        ms = device_time(lambda *a: cuda_conv_dxdw_fused.conv_dx_dw_fused(*a, mode), (src, w2, nbr, f), iters=iters)
        row[mode + "_ms"] = ms
        print(f"  {name:44s} ok {ms:8.3f} ms", flush=True)
    # the f32 kernel takes no channel padding: c_src and c_dst in multiples of 32, c_f of 4
    if src.device.type == "cuda" and (src.shape[1] % 32 or w2.shape[2] % 32 or f.shape[1] % 4):
        row["f32_ms"] = None
        print(f"  {'f32 conv_dx_dw (one gather per product)':44s}    does not take these widths", flush=True)
        return row
    ms = device_time(cuda_conv_dxdw.conv_dx_dw, (src, w2, nbr, f), iters=iters)
    row["f32_ms"] = ms
    print(f"  {'f32 conv_dx_dw (one gather per product)':44s}    {ms:8.3f} ms", flush=True)
    return row


def main(device="cuda", step_shapes=None, iters: int = 10):
    """Run the probe on ``device`` (``step_shapes`` defaults to ``STEP_SHAPES``);
    returns one dict of readings per shape."""
    step_shapes = STEP_SHAPES if step_shapes is None else step_shapes
    rng = np.random.default_rng(0)
    rows = [_run("probe", probe_inputs(rng), device, iters)]
    for label, m, k, c_src, c_dst, c_f in step_shapes:
        rows.append(_run(label, step_inputs(rng, m, k, c_src, c_dst, c_f), device, iters))
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
