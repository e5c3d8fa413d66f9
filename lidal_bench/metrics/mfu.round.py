"""Useful FLOPs of the window's round calls over the window's seconds, as a
share (%) of the H100's dense TF32 peak (495 TFLOP/s): each frame's 8 views'
eval forwards, 2 x real pairs x cin x cout per conv (1x1 convs and the
classifier over the valid rows), real pairs from the benchmark's own map
construction over each view's level-0 voxels.  Every call of the window
scores the same frames with the same views, so one call's count is each
call's."""

from lidal_bench.work import PEAK_TF32


def read(rec):
    flops = rec.get("flops") or []
    if not flops or not rec.get("window_s"):
        return None
    return 100.0 * sum(flops) / rec["window_s"] / PEAK_TF32
