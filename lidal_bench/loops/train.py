"""The loop of the training traffic: the port's ``run_train`` over a generated
SemanticKITTI sequence, fed by the port's ``FrameBatchLoader`` through a
thin proxy that times each batch fetch and closes the window.

One ``run_train`` call runs the whole cell.  Its first ``checked_steps``
steps are set-up and the check's steps (the reference follows them), then
``warmup_steps`` more; the window starts at a synchronise after them and
ends at the first batch fetch past ``--seconds``, at a second synchronise.
Each step's end is a device timestamp taken in ``on_step`` with no host
wait.  A traced run then profiles ``profiled_steps`` steps and times the
instrumented kernels over ``kernel_timed_steps`` more.  The proxy ends the
call by raising, so ``run_train``'s final checkpoint is never written.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from lidal_bench import check, profile, work
from lidal_bench.patching import Instruments, Patches, span
from lidal_bench.reference import data as rdata
from lidal_bench.reference.model import build, seeded_weights
from lidal_bench.reference.train import run_steps
from lidal_bench.timing import Clock
from lidal_bench.traffic import scan


class WindowClosed(Exception):
    """Raised by the feed to end ``run_train`` once the measurements are taken."""


class Feed:
    """The loader ``run_train`` sees: the port's loader, its fetches timed."""

    def __init__(self, inner, run: "Run"):
        self.inner, self.run = inner, run
        self.files, self.batch_size = inner.files, inner.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def __iter__(self):
        it = iter(self.inner)
        try:
            while True:
                self.run.before_batch()
                t = time.perf_counter()
                with torch.profiler.record_function("lidal_bench.loader_next"):
                    b = next(it, None)
                wait = time.perf_counter() - t
                if b is None:
                    return
                self.run.got_batch(b, wait)
                yield b
        finally:
            it.close()


class Run:
    def __init__(self, rc, tr: Dict, weights, device):
        self.rc, self.tr, self.weights, self.dev = rc, tr, weights, device
        self.clock = Clock(device)
        self.phase = "setup"
        self.state = None
        self.losses: List = []
        self.grad1: Dict = {}
        self.delta: Dict = {}
        self.points: List[int] = []
        self.waits: List[float] = []
        self.ends: List = []
        self.captured: List = []
        self.phase_steps = 0
        self.batch_points = 0
        self.batch_wait = 0.0
        self.prof = None
        self.profile = None
        self.instruments = Instruments(rc.instruments, self.clock) if rc.trace else None
        self.spans = Patches([("lidal_tpu_torch.runtime.train_loop", name, span(name))
                              for name in ("prepare_train_batch", "train_step")])
        self.t0 = self.t_end = self.e0 = None
        self.setup_s = self.t_step1 = None

    # -- the feed's hooks ------------------------------------------------------
    def got_batch(self, b, wait: float) -> None:
        self.batch_points, self.batch_wait = int(np.asarray(b["valid"]).sum()), wait

    def before_batch(self) -> None:
        tr = self.tr
        if self.phase == "window" and time.perf_counter() - self.t0 >= self.rc.seconds:
            self.clock.sync()
            self.t_end = time.perf_counter()
            if not self.rc.trace:
                raise WindowClosed
            self._enter("profile")
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.spans.install()
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
        elif self.phase == "profile" and self.phase_steps >= tr["profiled_steps"]:
            self.clock.sync()
            self.prof.stop()
            self.spans.uninstall()
            self.profile = profile.trace_to(self.prof, self.rc.workdir)
            self.prof = None
            self._enter("kernels")
            self.instruments.install()
        elif self.phase == "kernels" and self.phase_steps >= tr["kernel_timed_steps"]:
            self.clock.sync()
            self.instruments.uninstall()
            raise WindowClosed

    def _enter(self, phase: str) -> None:
        self.phase, self.phase_steps = phase, 0

    def on_step(self, step: int, loss) -> None:
        tr = self.tr
        self.phase_steps += 1
        if self.phase == "setup":
            if step == 1:
                self.clock.sync()
                self.t_step1 = self.rc.since_start()
            self.losses.append(loss)
            named = dict(self.state.model.named_parameters())
            if step == 1:  # the first gradient as Adam got it: exp_avg = (1 - beta1) * g
                opt_state = self.state.optimizer.state  # a leaf Adam never stepped reads as infinitely far
                self.grad1 = {n: opt_state[p]["exp_avg"].norm() / 0.1 if "exp_avg" in opt_state.get(p, {})
                              else torch.tensor(float("inf")) for n, p in named.items()}
            if step == tr["checked_steps"]:
                self.delta = {n: (p.detach() - self.weights[n]).norm() for n, p in named.items()}
            if step == tr["checked_steps"] + tr["warmup_steps"]:
                self.clock.sync()
                self.setup_s = self.rc.since_start()
                self.t0 = time.perf_counter()
                self.e0 = self.clock.mark()
                self._enter("window")
        elif self.phase == "window":
            self.ends.append(self.clock.mark())
            self.points.append(self.batch_points)
            self.waits.append(self.batch_wait)
            self.losses.append(loss)

    def capture_step(self, orig):
        """``train_step`` keeping each window batch's level-0 voxels (traced runs: the FLOP count)."""

        def train_step(state, tb, *a, **k):
            if self.phase == "window":
                lv0 = tb.plan.levels[0]
                self.captured.append((lv0.coords, lv0.valid))
            return orig(state, tb, *a, **k)

        return train_step


def _step_flops(captured, cfg: Dict) -> List[float]:
    layers = work.unet_layers(cfg["cs"], cfg["in_channels"], cfg["num_classes"], cfg["spvcnn"])
    out = []
    for coords, valid in captured:
        total = 0.0
        for b in range(coords.shape[0]):
            fr = rdata.build_frame(coords[b][valid[b]], cfg["level_caps"])
            rows, subm, down = rdata.level_counts(fr)
            total += work.pass_flops(layers, rows, subm, down, train=True)
        out.append(total)
    return out


def make_inputs(rc, dev):
    """The run's inputs from ``--seed``: the frames written as a SemanticKITTI
    sequence under the run's work directory, and the initial weights on the
    device.  Returns ``(data_root, weights)``."""
    cfg, tr = rc.config, rc.traffic
    shutil.rmtree(rc.workdir, ignore_errors=True)
    os.makedirs(rc.workdir)
    frames, poses = scan.generate(rc.seed, tr["frames"], tr["scan"], dev)
    data_root = scan.write_sequence(os.path.join(rc.workdir, "sequences"), "00", frames, poses)
    with torch.device("meta"):
        shapes = build(cfg["spvcnn"], cfg["num_classes"], cfg["cs"], cfg["in_channels"])
    return data_root, seeded_weights(shapes, rc.seed, dev)


def reference_steps(rc, data_root, weights, dev, **kw) -> Dict:
    """The reference over the run's first ``checked_steps`` batches."""
    tr = rc.traffic
    batches = rdata.epoch_batches(rdata.frame_files(data_root, "00"), rc.seed, 0, tr["batch_size"])
    return run_steps(batches, weights, rc.seed, {**rc.config, "batch_size": tr["batch_size"]}, dev,
                     tr["checked_steps"], **kw)


def run(rc) -> Dict:
    from lidal_tpu_torch.config import DataConfig, RunConfig
    from lidal_tpu_torch.data import semantic_kitti as sk
    from lidal_tpu_torch.data.loader import FrameBatchLoader
    from lidal_tpu_torch.runtime import train_loop

    cfg, tr, dev = rc.config, rc.traffic, torch.device(rc.device)
    t_begin = rc.since_start()
    data_root, weights = make_inputs(rc, dev)
    t_inputs = rc.since_start()
    data = DataConfig(name="SK", num_classes=cfg["num_classes"], scale=cfg["scale"], full_scale=cfg["full_scale"],
                      batch_size=tr["batch_size"], point_cap=cfg["point_cap"], level_caps=tuple(cfg["level_caps"]),
                      train_split=("00",), val_split=())
    rcfg = RunConfig(dataset_name="SK", model_name="SPVCNN" if cfg["spvcnn"] else "Mink", r_id=tr["r_id"],
                     seed=rc.seed, data_root=data_root, processing_root=os.path.join(rc.workdir, "Processing_files"),
                     checkpoint_root=os.path.join(rc.workdir, "check_points"), data_override=data)
    files = sk.list_frames(data_root, ["00"])
    inner = FrameBatchLoader(files, train_loop.make_sk_read_fn(rcfg), point_cap=data.point_cap,
                             batch_size=data.batch_size, shuffle=True, seed=rcfg.seed)
    r = Run(rc, tr, weights, dev)

    orig_init, orig_step = train_loop.init_state, train_loop.train_step

    def init_state(cfg_, device, group=None):
        st = orig_init(cfg_, device, group)
        with torch.no_grad():
            for n, p in st.model.named_parameters():
                p.copy_(weights[n])
        r.state = st
        return st

    train_loop.init_state = init_state
    if rc.trace:
        train_loop.train_step = r.capture_step(orig_step)
    try:
        train_loop.run_train(rcfg, loader=Feed(inner, r), max_iter=10**9, on_step=r.on_step, device=dev)
        raise RuntimeError("run_train returned before the window closed")
    except WindowClosed:
        pass
    finally:
        r.spans.uninstall()
        if r.instruments is not None:
            r.instruments.uninstall()
        train_loop.init_state, train_loop.train_step = orig_init, orig_step
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    window_s = r.t_end - r.t0
    print(f"[setup] s since process start: harness entered {t_begin:.2f}, inputs written {t_inputs:.2f}, "
          f"first step done {r.t_step1:.2f}, window opened {r.setup_s:.2f}", file=sys.stderr)
    intervals = [r.clock.seconds(a, b) for a, b in zip([r.e0] + r.ends[:-1], r.ends)]
    losses = [float(x) for x in r.losses]
    prog = {"loss": losses[: tr["checked_steps"]],
            "grad1": {n: float(v) for n, v in r.grad1.items()},
            "delta": {n: float(v) for n, v in r.delta.items()}}
    record = {"window_s": window_s, "points": r.points, "waits": r.waits, "intervals": intervals}
    if rc.trace:
        record["profile"] = r.profile
        record["calls"] = r.instruments.reduce()
        record["flops"] = _step_flops(r.captured, cfg)
    n_window = len(r.ends)
    failed = sum(1 for x in losses[tr["checked_steps"]:] if not np.isfinite(x))
    r.state = r.captured = r.instruments = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(rc, data_root, weights, dev)
    med = float(np.median(list(ref["grad1"].values())))
    still = sorted(n for n, g in ref["grad1"].items() if g < check.MOVED_FLOOR * med)
    print(f"[check] leaves left out of delta_gap (reference gradient under {check.MOVED_FLOOR} of the median "
          f"leaf's): {len(still)} of {len(ref['grad1'])} {still}", file=sys.stderr)
    shutil.rmtree(rc.workdir, ignore_errors=True)
    return {
        "e2e": {"train_points_per_s": sum(r.points) / window_s,
                "train_step_p90_ms": 1e3 * float(np.percentile(intervals, 90)),
                "setup_s": r.setup_s},
        "record": record,
        "readings": check.train_readings(prog, ref),
        "levels": ref["counts"],
        "attempted": n_window,
        "failed": failed,
        "memory_peak_bytes": peak,
    }
