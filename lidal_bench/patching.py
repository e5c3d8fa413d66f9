"""Wrappers the harness puts around functions of the program, and takes
off again: spans for the profiler, and per-call device timing with the
work each call needed (the kernel metrics).  The program is never edited;
a module attribute (or a class attribute) is replaced while a phase runs."""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from lidal_bench.timing import Clock


class Instruments:
    """Wraps program functions to time each call between device timestamps
    and count its work with the metric's own function (after the call, off
    the timed span)."""

    def __init__(self, specs, clock: Clock):
        self.specs, self.clock = specs, clock
        self.calls: Dict[str, List] = {}
        self.saved = []

    def install(self) -> None:
        for group, mod_name, attr, work_fn in self.specs:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)

            def wrapped(*a, _orig=orig, _group=group, _work=work_fn, **k):
                t0 = self.clock.mark()
                out = _orig(*a, **k)
                t1 = self.clock.mark()
                self.calls.setdefault(_group, []).append((t0, t1, _work(a, k, out)))
                return out

            self.saved.append((mod, attr, orig))
            setattr(mod, attr, wrapped)

    def uninstall(self) -> None:
        for mod, attr, orig in reversed(self.saved):
            setattr(mod, attr, orig)
        self.saved = []

    def reduce(self) -> Dict[str, List]:
        return {g: [(float(w[0]), float(w[1]), self.clock.seconds(t0, t1)) for t0, t1, w in rows]
                for g, rows in self.calls.items()}


def span(name: str):
    """A wrapper maker: the wrapped call runs inside a profiler range
    ``lidal_bench.<name>``, the host span an idle gap is labelled by."""
    def wrap(orig):
        def spanned(*a, **k):
            with torch.profiler.record_function(f"lidal_bench.{name}"):
                return orig(*a, **k)
        return spanned
    return wrap


def span_result(name: str):
    """A wrapper maker for a function that returns a function: the returned
    function runs inside the span."""
    def wrap(orig):
        def make(*a, **k):
            return span(name)(orig(*a, **k))
        return make
    return wrap


class Patches:
    """Attributes of modules (by name) or classes replaced by wrappers of
    themselves, and restored."""

    def __init__(self, specs):
        self.specs, self.saved = specs, []

    def install(self) -> None:
        for target, attr, make in self.specs:
            mod = importlib.import_module(target) if isinstance(target, str) else target
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))
            setattr(mod, attr, make(orig))

    def uninstall(self) -> None:
        for mod, attr, orig in reversed(self.saved):
            setattr(mod, attr, orig)
        self.saved = []
