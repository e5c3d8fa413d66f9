"""Mean host ms per call of the program's span ``ptv3.serialize``: a PTv3
forward's serialization (the curve codes of every level, their sorts and
inverses, the order shuffle and the patches, ``models/ptv3``), with its one
read of the levels' voxel counts.

Read from ``lidal_tpu_torch.utils.profiling.stats()`` after the run: the
recorder holds the spans of the traced stretch, the only stretch a profiler
runs in.  None where the program has no such span."""

SPAN = "ptv3.serialize"


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
