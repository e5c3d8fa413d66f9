"""Reduction of a ``torch.profiler`` trace of a short steady stretch to the
device's busy time, its idle share, the device operations that took most
time and the longest idle gaps, each labelled by the host span (the
benchmark's own ``record_function`` ranges) it overlapped most."""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_PREFIX = "lidal_bench."


def reduce_trace(path: str, top: int = 10) -> Dict:
    """``{"busy_s", "window_s", "device_ops": [[name, s]], "idle_gaps": [[label, s]]}``
    of the chrome trace at ``path``; ``busy_s`` 0 when the trace holds no
    device activity."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
                 for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"][len(HOST_PREFIX):])
            for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith(HOST_PREFIX)]
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        by_name[n[:120]] += (e - s) * 1e-6
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    gap_rows: List = []
    for gs, ge in longest:
        label = max(((min(ge, he) - max(gs, hs), name) for hs, he, name in host), default=(0.0, ""))
        gap_rows.append([f"host: {label[1]}" if label[0] > 0 else "host: outside the benchmark's spans",
                         (ge - gs) * 1e-6])
    return {
        "busy_s": busy * 1e-6,
        "window_s": (cur_e - dev[0][0]) * 1e-6,
        "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": gap_rows,
    }


def trace_to(prof, directory: str) -> Dict:
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return reduce_trace(path)
    finally:
        os.remove(path)
