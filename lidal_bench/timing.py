"""Device timestamps without a host wait: CUDA events on a card, the host
clock on the CPU (where the tests drive a run), behind one interface."""

from __future__ import annotations

import time

import torch


class Clock:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        """A timestamp of the work enqueued so far on the current stream."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        """Seconds from mark ``a`` to mark ``b``; both must have completed
        (call :meth:`sync` first)."""
        if self.cuda:
            return a.elapsed_time(b) / 1e3
        return b - a

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
