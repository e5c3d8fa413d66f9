"""The loop of PTv3's training traffic: the port's ``run_train`` with
``model_name="PTv3"`` over a generated SemanticKITTI sequence, timed, traced
and checked as ``loops/train.py`` times, traces and checks the U-Nets (its
feed and run are reused), against ``reference/ptv3.py``.

Closed-loop training, steps back to back.  A traced run's FLOPs
(``record["flops"]``) are PTv3's (``work/ptv3.step_flops``).
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
from typing import Dict, List

import numpy as np
import torch

from lidal_bench import check
from lidal_bench.loops.train import Feed, Run, WindowClosed
from lidal_bench.reference import data as rdata
from lidal_bench.reference import ptv3 as rptv3
from lidal_bench.traffic import scan
from lidal_bench.work import ptv3 as wptv3


def step_flops(captured, cfg: Dict) -> List[float]:
    out = []
    for coords, valid in captured:
        frames = [rdata.build_frame(coords[b][valid[b]], cfg["level_caps"]) for b in range(coords.shape[0])]
        out.append(wptv3.step_flops(frames, cfg["num_classes"], cfg["in_channels"]))
    return out


def make_inputs(rc, dev):
    """The frames written as a SemanticKITTI sequence under the run's work
    directory, and PTv3's initial weights on the device, from ``--seed``."""
    cfg, tr = rc.config, rc.traffic
    shutil.rmtree(rc.workdir, ignore_errors=True)
    os.makedirs(rc.workdir)
    frames, poses = scan.generate(rc.seed, tr["frames"], tr["scan"], dev)
    data_root = scan.write_sequence(os.path.join(rc.workdir, "sequences"), "00", frames, poses)
    with torch.device("meta"):
        shapes = rptv3.PTv3(cfg["num_classes"], cfg["in_channels"])
    return data_root, rptv3.seeded_weights(shapes, rc.seed, dev)


def reference_steps(rc, data_root, weights, dev, fault=None) -> Dict:
    tr = rc.traffic
    batches = rdata.epoch_batches(rdata.frame_files(data_root, "00"), rc.seed, 0, tr["batch_size"])
    return rptv3.run_steps(batches, weights, rc.seed, {**rc.config, "batch_size": tr["batch_size"]}, dev,
                           tr["checked_steps"], fault=fault)


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
    rcfg = RunConfig(dataset_name="SK", model_name=cfg["model"], r_id=tr["r_id"], seed=rc.seed, data_root=data_root,
                     processing_root=os.path.join(rc.workdir, "Processing_files"),
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
        record["flops"] = step_flops(r.captured, cfg)
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
