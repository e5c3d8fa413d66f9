"""The port's tracing: named spans and counters in one in-process recorder
(the JAX package's ``utils/profiling.py`` has phase timers instead).

* :func:`span` marks a stretch of host work at a layer boundary, named
  ``<layer>.<what>`` (``train.step``, ``loader.queue_wait``,
  ``round.aggregate``, ...).  With no ``torch.profiler`` running it returns
  one shared no-op context: the cost is a read of torch's profiler flag.
  Under a profiler it opens ``torch.profiler.record_function("lidal." +
  name)``, so the span lies on the trace's clock beside the kernels it
  queued, and adds to an aggregate per name: count, total seconds and self
  seconds (the total less the time of the spans nested in it on the same
  thread).  Spans record on every thread.  The aggregate holds the latest
  profiled stretch: the first span recorded after spans were last seen off
  clears it.
* :func:`count` adds to a named counter, always, under one lock: the
  kernels' launches (``launch.<kernel>``), the collectives
  (``all_reduce.calls``, ``all_reduce.bytes``) and the batch plan's CUDA
  graphs (``plan_graph.capture``, ``plan_graph.replay``).  Inside
  :func:`diverted_counts` a thread's counts go to a dict instead: a CUDA
  graph's capture runs nothing, and its launches count when it replays.
* :func:`stats` reads both, :func:`reset` clears both.
* :func:`device_trace` is the way to trace a call: every thread of the
  host, the card's kernels and copies, and a ``summary.json`` of the spans
  and counters of the stretch.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "lidal."

_LOCK = threading.Lock()
_SPANS: Dict[str, list] = {}  # name -> [count, total seconds, self seconds]
_COUNTERS: Dict[str, int] = {}
_OPEN = threading.local()  # .stack: this thread's open spans, innermost last
_DIVERTED = threading.local()  # .counts: the dict this thread's counts go to, or None
_OFF = contextlib.nullcontext()
_seen_off = True  # a span found no profiler running since the aggregate was last cleared


class _Span:
    __slots__ = ("name", "range", "start", "inner")

    def __init__(self, name: str) -> None:
        self.name = name
        self.range = torch.profiler.record_function(PREFIX + name)

    def __enter__(self) -> "_Span":
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.range.__enter__()
        stack.append(self)
        self.inner = 0.0
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        took = time.perf_counter() - self.start
        stack = _OPEN.stack
        stack.pop()
        if stack:
            stack[-1].inner += took
        self.range.__exit__(*exc)
        with _LOCK:
            agg = _SPANS.get(self.name)
            if agg is None:
                agg = _SPANS[self.name] = [0, 0.0, 0.0]
            agg[0] += 1
            agg[1] += took
            agg[2] += took - self.inner


def span(name: str):
    """A context that records ``name`` while a ``torch.profiler`` runs and
    does nothing otherwise."""
    global _seen_off
    if not _autograd_profiler._is_profiler_enabled:
        _seen_off = True
        return _OFF
    if _seen_off:
        with _LOCK:
            if _seen_off:
                _SPANS.clear()
                _seen_off = False
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    diverted = getattr(_DIVERTED, "counts", None)
    if diverted is not None:
        diverted[name] = diverted.get(name, 0) + n
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


@contextlib.contextmanager
def diverted_counts() -> Iterator[Dict[str, int]]:
    """Collect what this thread counts inside the block in the dict it
    yields, and leave the counters as they are; other threads count as
    before."""
    outer = getattr(_DIVERTED, "counts", None)
    _DIVERTED.counts = counts = {}
    try:
        yield counts
    finally:
        _DIVERTED.counts = outer


def counter(name: str) -> int:
    """The counter ``name`` (0 before its first count)."""
    with _LOCK:
        return _COUNTERS.get(name, 0)


def stats() -> Dict[str, Dict]:
    """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters": {name: n}}``."""
    with _LOCK:
        spans = {n: {"count": c, "total_s": t, "self_s": s} for n, (c, t, s) in _SPANS.items()}
        return {"spans": spans, "counters": dict(_COUNTERS)}


def reset() -> None:
    """Clear the spans and the counters."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()


def _all_threads() -> Optional[torch._C._profiler._ExperimentalConfig]:
    """A profiler setting that traces every thread, where this torch has one
    (otherwise only the thread that starts the profiler is traced)."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (TypeError, AttributeError):
        return None


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the enclosed call: a ``torch.profiler`` trace of every thread's
    host work and spans and, where there is a card, its kernels and copies
    (a Chrome / TensorBoard ``*.pt.trace.json``), and ``summary.json`` with
    :func:`stats` of the stretch, both under ``log_dir``; a no-op when
    ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    reset()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, experimental_config=_all_threads(),
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
    with open(os.path.join(log_dir, "summary.json"), "w") as f:
        json.dump(stats(), f, indent=2)
