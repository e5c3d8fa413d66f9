"""Mean host ms per call of the program's span ``train.prepare_batch``: a step's
host time in ``prepare_train_batch`` with its draws
(``runtime/train_loop.run_train``).

Read from ``lidal_tpu_torch.utils.profiling.stats()`` after the run: the
recorder holds the spans of the traced stretch, the only stretch a profiler
runs in.  None where the program has no such span."""

SPAN = "train.prepare_batch"


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
