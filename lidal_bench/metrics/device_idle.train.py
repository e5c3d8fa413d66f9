"""Share (%) of a profiled stretch of steady train steps, right after the
window, in which no kernel, copy or memset ran on the device
(``torch.profiler`` CUDA activity)."""


def read(rec):
    prof = rec.get("profile") or {}
    if not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
