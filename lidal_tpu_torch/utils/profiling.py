"""Tracing / profiling utilities (port of ``lidal_tpu/utils/profiling.py``).

The reference's observability is ``time.time()`` around the eval loop and loss
prints (``evaluate.py:81,125-126``, ``train.py:149``).  Here: named phase
timers that wait for the card's queued work, per-step throughput meters, and
an optional ``torch.profiler`` trace context (Chrome / TensorBoard traces).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


def _synchronize(tree) -> None:
    """Wait for the work queued on the CUDA devices of the tensors in ``tree``."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


class PhaseTimer:
    """Accumulating named phase timer.  ``sync=True`` waits for the device work
    of ``block_on`` (a tensor or a tree of them) so a phase's time includes its
    asynchronous launches."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and self.sync:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:32s} {t:9.3f}s total  {t / max(c, 1) * 1e3:9.2f} ms/call  x{c}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            n: {"total_s": self.totals[n], "calls": self.counts[n]} for n in self.totals
        }

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)


class ThroughputMeter:
    """EMA-smoothed items/sec meter for train/inference loops."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.rate: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self, items: int) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = items / max(now - self._last, 1e-9)
            self.rate = inst if self.rate is None else (
                (1 - self.alpha) * self.rate + self.alpha * inst
            )
        self._last = now
        return self.rate or 0.0


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the host and, where there is a card, of its
    kernels, written under ``log_dir`` on exit; a no-op when ``log_dir`` is
    None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
