"""The loop of data-parallel training traffic: the port's ``run_train`` over
a process group of ``ranks`` processes, one a card (NCCL; gloo on the CPU),
``batch_size`` frames a rank, so ``ranks x batch_size`` frames a global step.

Rank 0 runs in the harness process and is the one measured, timed, traced
and checked, as ``loops/train.py`` does a single card (its run is reused);
ranks 1 to ``ranks - 1`` are spawned processes that join the group at a
free localhost port and run the same steps.  Each rank reads its rows of
every global batch (``FrameBatchLoader.with_rows``), as ``run_train`` asks.
Before each batch fetch rank 0 tells the others over a gloo group whether
the run goes on, so every rank leaves ``run_train`` after the same step.

``train_points_per_s`` counts the global batch's valid points over rank 0's
window (each rank's points gathered after the window); the check compares
rank 0's first steps with the reference's steps over the same global
batches (``reference/train.run_steps`` with a batch of ``ranks x
batch_size`` frames: one loss over the global batch, BN statistics over
every frame, which is what the group's sums give).

``RANK_HOOK`` (None in the benchmark's runs) is ``(function, argument)``
that each spawned rank calls before it joins the group: how ``control_dp``
plants a fault in every rank (in rank 0, the harness process, it plants the
fault itself).
"""

from __future__ import annotations

import copy
import datetime
import gc
import os
import shutil
import socket
import sys
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils.checkpoint import checkpoint

from lidal_bench import check
from lidal_bench.loops import train as single
from lidal_bench.loops.train import Run, WindowClosed
from lidal_bench.reference import data as rdata
from lidal_bench.reference import model as rmodel
from lidal_bench.reference.train import run_steps

TIMEOUT = datetime.timedelta(minutes=10)  # a collective waits this long for a rank that died
RANK_HOOK = None

# The cell this loop is written for, and the metrics that read its rank 0.
# BENCHMARK.json does not list it: run.py's ``card`` reports one device
# whatever a cell's ``chips``, so a four-card run would report the wrong
# count.  ``with_cell`` adds it to a loaded benchmark for ``control_dp`` and
# the loop's tests.
CELL = {"name": "sk_minkunet_train_dp4", "config": "minkunet_sk", "traffic": "train_b5_dp4", "chips": 4,
        "why": "MinkUNet data parallel over 4 NCCL ranks, B=5 a rank (20 frames a step): gradient and sync-BN "
               "all-reduces, stragglers"}
METRICS = ("train_points_per_s", "train_step_p90_ms", "loader_wait_ms.train", "device_idle.train",
           "conv_fwd_roofline.train", "conv_bwd_roofline.train", "loader_queue_wait_ms.train",
           "batch_upload_ms.train", "batch_prep_ms.train", "step_host_ms.train")


def with_cell(bench: Dict) -> Dict:
    """``bench`` with :data:`CELL` appended and listed by :data:`METRICS`."""
    bench = copy.deepcopy(bench)
    bench["workloads"].append(dict(CELL))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(CELL["name"])
    return bench


class RankFeed:
    """The loader one rank's ``run_train`` sees: the port's loader (its rows of
    each global batch), each fetch agreed with rank 0 first.  Rank 0 passes
    its :class:`Run` (whose ``before_batch`` decides and may end the run);
    every rank keeps each batch's valid points."""

    def __init__(self, inner, control, run=None):
        self.inner, self.control, self.run = inner, control, run
        self.files, self.batch_size = inner.files, inner.batch_size
        self.points: List[int] = []

    def with_rows(self, lo: int, hi: int) -> "RankFeed":
        out = RankFeed(self.inner.with_rows(lo, hi), self.control, self.run)
        out.points = self.points
        return out

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def _go_on(self) -> None:
        flag = torch.zeros(1, dtype=torch.int32)
        ended = None
        if self.run is not None:
            try:
                self.run.before_batch()
                flag[0] = 1
            except WindowClosed as e:
                ended = e
        dist.broadcast(flag, 0, group=self.control)
        if ended is not None:
            raise ended
        if not int(flag[0]):
            raise WindowClosed

    def __iter__(self):
        it = iter(self.inner)
        try:
            while True:
                self._go_on()
                t = time.perf_counter()
                with torch.profiler.record_function("lidal_bench.loader_next"):
                    b = next(it, None)
                wait = time.perf_counter() - t
                if b is None:
                    return
                self.points.append(int(np.asarray(b["valid"]).sum()))
                if self.run is not None:
                    self.run.got_batch(b, wait)
                yield b
        finally:
            it.close()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(rank: int, ranks: int, port: int, device: str) -> torch.device:
    """This rank in the group, through the port's own ``mesh.init_group``
    (NCCL on ``cuda:rank``, gloo on the CPU)."""
    from lidal_tpu_torch.parallel import mesh

    return mesh.init_group(rank, ranks, f"tcp://127.0.0.1:{port}", device, TIMEOUT)


def _run_config(cfg: Dict, tr: Dict, seed: int, workdir: str, data_root: str):
    from lidal_tpu_torch.config import DataConfig, RunConfig

    data = DataConfig(name="SK", num_classes=cfg["num_classes"], scale=cfg["scale"], full_scale=cfg["full_scale"],
                      batch_size=tr["batch_size"], point_cap=cfg["point_cap"], level_caps=tuple(cfg["level_caps"]),
                      train_split=("00",), val_split=())
    return RunConfig(dataset_name="SK", model_name="SPVCNN" if cfg["spvcnn"] else "Mink", r_id=tr["r_id"],
                     seed=seed, data_root=data_root, processing_root=os.path.join(workdir, "Processing_files"),
                     checkpoint_root=os.path.join(workdir, "check_points"), data_override=data)


def _feed(rcfg, ranks: int, control, run=None) -> RankFeed:
    from lidal_tpu_torch.data import semantic_kitti as sk
    from lidal_tpu_torch.data.loader import FrameBatchLoader
    from lidal_tpu_torch.runtime import train_loop

    data = rcfg.data
    inner = FrameBatchLoader(sk.list_frames(rcfg.data_root, ["00"]), train_loop.make_sk_read_fn(rcfg),
                             point_cap=data.point_cap, batch_size=data.batch_size * ranks, shuffle=True,
                             seed=rcfg.seed)
    return RankFeed(inner, control, run)


def _rank_main(rank: int, ranks: int, port: int, device: str, run_args: tuple, threads: int, hook) -> None:
    """A spawned rank: the same steps as rank 0 until rank 0 ends the run,
    then its points to rank 0."""
    from lidal_tpu_torch.runtime import train_loop

    if threads:
        torch.set_num_threads(threads)
    if hook is not None:
        hook[0](hook[1])
    dev = _join(rank, ranks, port, device)
    control = dist.new_group(backend="gloo", timeout=TIMEOUT)
    group = dist.group.WORLD
    rcfg = _run_config(*run_args)
    feed = _feed(rcfg, ranks, control)
    try:
        train_loop.run_train(rcfg, loader=feed, max_iter=10**9, device=dev, group=group)
    except WindowClosed:
        pass
    dist.gather_object(feed.points, None, dst=0, group=control)
    dist.destroy_process_group()


def _recomputed(subm):
    """``reference/model.subm`` whose gathered rows its backward recomputes
    (the same gathers and products again) instead of keeping them."""

    def run(x, w, nbr):
        return checkpoint(subm, x, w, nbr, use_reentrant=False)

    return run


def reference_steps(rc, data_root, weights, dev, **kw) -> Dict:
    """The reference over the run's first ``checked_steps`` global batches,
    epoch after epoch, on rank 0's card (``kw``: ``run_steps``'s ``use_tf32``
    or ``fault``).  A global batch's tap-loop convs keep more gathered rows
    for their backward than one card holds (20 frames: over 79 GB), so each
    conv recomputes its own in the backward."""
    tr = rc.traffic
    b = tr["ranks"] * tr["batch_size"]
    files = rdata.frame_files(data_root, "00")
    batches, epoch = [], 0
    while len(batches) < tr["checked_steps"]:
        batches += rdata.epoch_batches(files, rc.seed, epoch, b)
        epoch += 1
    orig = rmodel.subm
    rmodel.subm = _recomputed(orig)
    try:
        return run_steps(batches, weights, rc.seed, {**rc.config, "batch_size": b}, dev, tr["checked_steps"], **kw)
    finally:
        rmodel.subm = orig


def run(rc) -> Dict:
    from lidal_tpu_torch.parallel.mesh import init_group  # noqa: F401  (first: a port without it stops here)
    from lidal_tpu_torch.runtime import train_loop

    cfg, tr = rc.config, rc.traffic
    ranks = tr["ranks"]
    t_begin = rc.since_start()
    dev = torch.device(rc.device)
    data_root, weights = single.make_inputs(rc, dev)
    t_inputs = rc.since_start()
    port = _free_port()
    ctx = mp.get_context("spawn")
    threads = torch.get_num_threads() if dev.type == "cpu" else 0
    run_args = (cfg, tr, rc.seed, rc.workdir, data_root)
    procs = [ctx.Process(target=_rank_main, args=(r, ranks, port, rc.device, run_args, threads, RANK_HOOK),
                         daemon=True) for r in range(1, ranks)]
    for p in procs:
        p.start()
    dev = _join(0, ranks, port, rc.device)
    control = dist.new_group(backend="gloo", timeout=TIMEOUT)
    group = dist.group.WORLD
    rcfg = _run_config(*run_args)
    r = Run(rc, tr, weights, dev)
    feed = _feed(rcfg, ranks, control, r)
    orig_init = train_loop.init_state

    def init_state(cfg_, device, group_=None):
        st = orig_init(cfg_, device, group_)
        with torch.no_grad():
            for n, p in st.model.named_parameters():
                p.copy_(weights[n].to(device))
        r.state = st
        return st

    train_loop.init_state = init_state
    try:
        train_loop.run_train(rcfg, loader=feed, max_iter=10**9, on_step=r.on_step, device=dev, group=group)
        raise RuntimeError("run_train returned before the window closed")
    except WindowClosed:
        pass
    finally:
        r.spans.uninstall()
        if r.instruments is not None:
            r.instruments.uninstall()
        train_loop.init_state = orig_init
    gathered: List = [None] * ranks
    dist.gather_object(feed.points, gathered, dst=0, group=control)
    dist.destroy_process_group()
    for p in procs:
        p.join(timeout=120)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    window_s = r.t_end - r.t0
    print(f"[setup] s since process start: harness entered {t_begin:.2f}, inputs written {t_inputs:.2f}, "
          f"first step done {r.t_step1:.2f}, window opened {r.setup_s:.2f}", file=sys.stderr)
    first = tr["checked_steps"] + tr["warmup_steps"]
    n_window = len(r.ends)
    points = [sum(pts[first + i] for pts in gathered) for i in range(n_window)]
    intervals = [r.clock.seconds(a, b) for a, b in zip([r.e0] + r.ends[:-1], r.ends)]
    losses = [float(x) for x in r.losses]
    prog = {"loss": losses[: tr["checked_steps"]],
            "grad1": {n: float(v) for n, v in r.grad1.items()},
            "delta": {n: float(v) for n, v in r.delta.items()}}
    record = {"window_s": window_s, "points": points, "waits": r.waits, "intervals": intervals}
    if rc.trace:
        record["profile"] = r.profile
        record["calls"] = r.instruments.reduce()
    failed = sum(1 for x in losses[tr["checked_steps"]:] if not np.isfinite(x))
    r.state = r.instruments = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(rc, data_root, weights, dev)
    shutil.rmtree(rc.workdir, ignore_errors=True)
    return {
        "e2e": {"train_points_per_s": sum(points) / window_s,
                "train_step_p90_ms": 1e3 * float(np.percentile(intervals, 90)),
                "setup_s": r.setup_s},
        "record": record,
        "readings": check.train_readings(prog, ref),
        "levels": ref["counts"],
        "attempted": n_window,
        "failed": failed,
        "memory_peak_bytes": peak,
    }
