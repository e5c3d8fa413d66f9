"""A kernel group's share (%) of its roofline: the sum over its timed calls
of max(operations / 495 TFLOP/s, bytes / 3.35 TB/s), over the calls' summed
device time (CUDA events around each call of the wrapped entry points, in
steady train steps after the window)."""

from lidal_bench.work import Bound


def share(rec, group: str):
    calls = (rec.get("calls") or {}).get(group) or []
    seconds = sum(s for _, _, s in calls)
    if not calls or seconds <= 0:
        return None
    bound = Bound()
    for ops, moved, _ in calls:
        bound.add(moved, ops)
    return 100.0 * bound.total / seconds
