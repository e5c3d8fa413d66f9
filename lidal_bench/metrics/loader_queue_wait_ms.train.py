"""Mean host ms per call of the program's span ``loader.queue_wait``: the train
step's wait for its batch from the loader's queue
(``data/loader.FrameBatchLoader``).

Read from ``lidal_tpu_torch.utils.profiling.stats()`` after the run: the
recorder holds the spans of the traced stretch, the only stretch a profiler
runs in.  None where the program has no such span."""

SPAN = "loader.queue_wait"


def read(rec):
    try:
        from lidal_tpu_torch.utils import profiling
    except ImportError:
        return None
    stats = getattr(profiling, "stats", None)
    s = stats()["spans"].get(SPAN) if stats is not None else None
    if not s or not s["count"]:
        return None
    return 1e3 * s["total_s"] / s["count"]
