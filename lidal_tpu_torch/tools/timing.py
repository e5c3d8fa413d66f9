"""Timing harness of the probes (the port's counterpart of
``tools/bench_suite.py:device_time``).

The JAX harness keeps its loop on the device and feeds the iteration index
into the function, because XLA would otherwise hoist a repeated computation
out of the loop and each dispatch through its backend costs milliseconds.
PyTorch runs eagerly and queues launches asynchronously, so here the loop is a
Python loop between two CUDA events and ``fn`` takes only its arguments.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def _device_of(args: Sequence) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("device_time needs at least one tensor argument to tell the device from")


def device_time(fn: Callable, args: Sequence, iters: int = 50, reps: int = 2) -> float:
    """Milliseconds per call of ``fn(*args)``: the best of ``reps`` timed loops
    of ``iters`` calls, after one warm-up call (which also builds a kernel at
    its first use).  CUDA tensors are timed with CUDA events on the current
    stream; CPU tensors with the host clock."""
    device = _device_of(args)
    fn(*args)
    best = None
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            ms = (time.perf_counter() - t0) / iters * 1e3
        best = ms if best is None else min(best, ms)
    return best
