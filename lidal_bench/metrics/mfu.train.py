"""Useful FLOPs of the window's train steps over the window's seconds, as a
share (%) of the H100's dense TF32 peak (495 TFLOP/s): per conv 2 x real
pairs x cin x cout for the forward, the same for dW and for dx where the
conv takes one; 1x1 convs and Linears over the valid rows.  Real pairs come
from the benchmark's own map construction over each window batch's
level-0 voxels (``lidal_bench/work``), whatever implements the kernels."""

from lidal_bench.work import PEAK_TF32


def read(rec):
    flops = rec.get("flops") or []
    if not flops or not rec.get("window_s"):
        return None
    return 100.0 * sum(flops) / rec["window_s"] / PEAK_TF32
