"""The loop of the fused-round traffic: the port's ``run_fused_lidal_round``
over a generated SemanticKITTI sequence, called again and again.

Set-up writes the round's inputs (frames, registered points from the
generator's poses, size-balanced k-means supervoxels, the round-0 flags),
makes the previous round's model from the seed (weights drawn on the
device, BN statistics from one train-mode pass of the benchmark's
reference model over the first frames), and runs one call to warm every
shape.  The window then repeats calls and ends at the end of the first
call that finishes past ``--seconds``.  The check reads the window's last
call: the sampled frames' probabilities (kept on the device as they are
made), the aggregated supervoxel scores and the selection; every call's
selection must equal the set-up call's.  A traced run then profiles one
call and times the instrumented kernels over another.
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

from lidal_bench import profile, work
from lidal_bench.patching import Instruments, Patches, span, span_result
from lidal_bench.reference import data as rdata
from lidal_bench.reference import round as rround
from lidal_bench.reference.model import BN, Maps, build, seeded_weights
from lidal_bench.reference.train import tf32
from lidal_bench.timing import Clock
from lidal_bench.traffic import scan, supervoxels


def _calibrated_weights(cfg: Dict, frames, seed: int, dev) -> Dict[str, torch.Tensor]:
    """Seeded weights and, as the previous round's BN statistics, the batch
    statistics of one train-mode pass of the reference over the first frames."""
    model = build(cfg["spvcnn"], cfg["num_classes"], cfg["cs"], cfg["in_channels"]).to(dev)
    weights = seeded_weights(model, seed, dev)
    model.load_state_dict(weights, strict=False)
    b = min(4, len(frames))
    gen = torch.Generator().manual_seed(seed)
    draws = rdata.draw_augment(gen, b)
    pad = {"point_cap": cfg["point_cap"]}
    xyz = np.zeros((b, pad["point_cap"], 3), np.float32)
    sig = np.zeros((b, pad["point_cap"]), np.float32)
    valid = np.zeros((b, pad["point_cap"]), bool)
    for i, (x, s, _) in enumerate(frames[:b]):
        n = min(len(x), pad["point_cap"])
        xyz[i, :n], sig[i, :n], valid[i, :n] = x[:n], s[:n], True
    xt, st, vt = (torch.from_numpy(a).to(dev) for a in (xyz, sig, valid))
    xa, coords, ok = rdata.voxel_coords(xt, vt, draws, cfg["scale"], cfg["full_scale"])
    fr_list, feats = [], []
    for i in range(b):
        pts = ok[i].nonzero()[:, 0]
        fr = rdata.build_frame(coords[i, pts], cfg["level_caps"])
        src = pts[fr.first]
        feats.append(torch.cat([xa[i, src], st[i, src, None]], 1))
        fr_list.append(fr)
    model.train()
    BN.calibrate = True
    try:
        with torch.no_grad():
            args = (list(range(b)), cfg["level_caps"]) if cfg["spvcnn"] else ()
            model(torch.cat(feats), Maps(fr_list), fr_list, *args)
    finally:
        BN.calibrate = False
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def make_inputs(rc, dev):
    """The round's input tree under the work directory and the model's weights.
    Returns (RunConfig, frames, registered xyz per frame, point2sv per frame,
    weights, total points)."""
    from lidal_tpu_torch.config import DataConfig, RunConfig
    from lidal_tpu_torch.runtime.paths import Paths

    cfg, tr = rc.config, rc.traffic
    shutil.rmtree(rc.workdir, ignore_errors=True)
    os.makedirs(rc.workdir)
    n = tr["frames"]
    frames, poses = scan.generate(rc.seed, n, tr["scan"], dev)
    data_root = scan.write_sequence(os.path.join(rc.workdir, "sequences"), "00", frames, poses)
    data = DataConfig(name="SK", num_classes=cfg["num_classes"], scale=cfg["scale"], full_scale=cfg["full_scale"],
                      point_cap=cfg["point_cap"], level_caps=tuple(cfg["level_caps"]), train_split=("00",),
                      val_split=())
    rcfg = RunConfig(dataset_name="SK", model_name="SPVCNN" if cfg["spvcnn"] else "Mink", label_unit="sv",
                     metric_name="LiDAL", r_id=tr["r_id"], seed=rc.seed, inf_reps=tr["inf_reps"],
                     view_chunk=tr["view_chunk"], data_root=data_root,
                     processing_root=os.path.join(rc.workdir, "Processing_files"),
                     checkpoint_root=os.path.join(rc.workdir, "check_points"), data_override=data)
    paths = Paths(rcfg)
    dirs = {"grid": paths.grid_dir("00"), "sv": paths.supervoxel_dir("00", "KMeans"),
            "flags": paths.sv_flag_dir("00", r_id=0)}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    g = np.random.default_rng([rc.seed, 4])
    labelled = set(g.choice(n, max(1, round(tr["labelled_frame_share"] * n)), replace=False).tolist())
    k = tr["supervoxels_per_frame"]
    point2sv = supervoxels.partition([f[0] for f in frames], k, rc.seed, dev)
    registered = []
    for i, ((xyz, _, _), pose, p2s) in enumerate(zip(frames, poses, point2sv)):
        name = f"{i:06d}"
        reg = (xyz.astype(np.float64) @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
        np.savez_compressed(os.path.join(dirs["grid"], f"{name}.npz"), xyz=reg)
        np.savez_compressed(os.path.join(dirs["sv"], f"{name}.npz"), point2sv=p2s,
                            sv_gid=np.arange(i * k, (i + 1) * k, dtype=np.int64))
        np.save(os.path.join(dirs["flags"], f"{name}.npy"), np.full(k, int(i in labelled), np.int32))
        registered.append(reg)
    weights = _calibrated_weights(cfg, frames, rc.seed, dev)
    return rcfg, frames, registered, point2sv, weights, sum(len(f[0]) for f in frames)


class Capture:
    """What the check reads from the program's calls: the sampled frames'
    probabilities, kept on the device as the set-up and window calls make
    them (the last window call's stay), the set-up call's views (for the
    traced run's FLOP count), and each call's aggregated scores and
    selection."""

    def __init__(self, keep):
        self.on = True
        self.views_on = True
        self.keep = set(keep)
        self.current = None
        self.probs: Dict[str, torch.Tensor] = {}
        self.calls: List[Dict] = []
        self.views: List = []
        self.read = None

    def multiview(self, orig):
        def make(*a, **k):
            fn = orig(*a, **k)

            def run(generator, xyz, sig, valid):
                out = fn(generator, xyz, sig, valid)
                if self.on and self.current in self.keep:
                    self.probs[self.current] = out[0].clone()  # on the frame's stream, no host wait
                return out
            return run
        return make

    def select(self, orig):
        def select_and_save(sv_flags, agg, tpn, *a, **k):
            res = orig(sv_flags, agg, tpn, *a, **k)
            self.calls.append({"prev": sv_flags.copy(), "d": agg.sv_interds.copy(), "e": agg.sv_interes.copy(),
                               "pnums": agg.sv_pnums.copy(), "centers": agg.sv_centers.copy(),
                               "flags": res.sv_flags.copy(), "tpn": tpn})
            return res
        return select_and_save

    def forward(self, orig):
        def forward_batch(model, batch, *a, **k):
            if self.views_on:
                lv0 = batch.plan.levels[0]
                self.views.append((lv0.coords, lv0.valid))
            return orig(model, batch, *a, **k)
        return forward_batch


def sampled_frames(rc) -> List[int]:
    """The frames whose probabilities the check compares, drawn from the
    seed; the first is also scored by the reference from its own
    probabilities of the frame's 24 neighbours (two such frames would keep
    the reference past the window in some runs)."""
    n = rc.traffic["frames"]
    return np.random.default_rng([rc.seed, 5]).choice(n, rc.traffic["checked_frames"], replace=False).tolist()


def _view_flops(views, cfg) -> float:
    layers = work.unet_layers(cfg["cs"], cfg["in_channels"], cfg["num_classes"], cfg["spvcnn"])
    total = 0.0
    for coords, valid in views:
        for b in range(coords.shape[0]):
            fr = rdata.build_frame(coords[b][valid[b]], cfg["level_caps"])
            rows, subm, down = rdata.level_counts(fr)
            total += work.pass_flops(layers, rows, subm, down, train=False)
    return total


def run(rc) -> Dict:
    from lidal_tpu_torch.active import lidal, lidal_runner
    from lidal_tpu_torch.runtime import prob_inference
    from lidal_tpu_torch.runtime.train_loop import build_model

    cfg, tr, dev = rc.config, rc.traffic, torch.device(rc.device)
    clock = Clock(dev)
    t_begin = rc.since_start()
    rcfg, frames, registered, point2sv, weights, total_points = make_inputs(rc, dev)
    t_inputs = rc.since_start()
    n = tr["frames"]
    model = build_model(rcfg).to(dev)
    model.load_state_dict(weights)
    model.eval()
    cap = Capture(f"{i:06d}" for i in sampled_frames(rc))

    def read(seq, name):
        cap.current = name
        raw = np.fromfile(os.path.join(rcfg.data_root, seq, "velodyne", f"{name}.bin"), np.float32).reshape(-1, 4)
        return raw[:, :3], raw[:, 3]

    cap.read = read

    def read_fn(seq, name):
        return cap.read(seq, name)

    def call():
        return lidal_runner.run_fused_lidal_round(rcfg, model, read_fn, train_split=["00"],
                                                  train_point_num=total_points, save_prob=tr["save_prob"],
                                                  device=dev)

    saved = [(lidal_runner, "make_multiview_fn"), (lidal_runner, "_select_and_save")]
    if rc.trace:
        saved.append((prob_inference, "forward_batch"))
    originals = [getattr(m, a) for m, a in saved]
    lidal_runner.make_multiview_fn = cap.multiview(originals[0])
    lidal_runner._select_and_save = cap.select(originals[1])
    if rc.trace:
        prob_inference.forward_batch = cap.forward(originals[2])
    record: Dict = {}
    try:
        call()  # set-up: warms every shape
        cap.views_on = False
        clock.sync()
        setup_s = rc.since_start()
        print(f"[setup] s since process start: harness entered {t_begin:.2f}, inputs written {t_inputs:.2f}, "
              f"window opened after the first call {setup_s:.2f}", file=sys.stderr)
        t0 = time.perf_counter()
        calls = 0
        while True:
            call()
            calls += 1
            if time.perf_counter() - t0 >= rc.seconds:
                break
        clock.sync()
        window_s = time.perf_counter() - t0
        cap.on = False
        last_call = len(cap.calls) - 1
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        record = {"window_s": window_s, "round_calls": calls, "frames": calls * n}
        if rc.trace:
            record["flops"] = [_view_flops(cap.views, cfg)] * calls
            cap.views = []
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            spans = Patches([(lidal_runner, "make_multiview_fn", span_result("multiview_inference")),
                             (lidal_runner, "load_grid_points", span("load_grid_points")),
                             (lidal, "score_slot", span("score_slot")),
                             (lidal_runner, "to_host", span("to_host")),
                             (lidal_runner._SvAggregator, "make_aggregate", span_result("sv_aggregate")),
                             (lidal_runner, "_select_and_save", span("select_and_save")),
                             (cap, "read", span("read_frame"))])
            spans.install()
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            try:
                call()
                clock.sync()
            finally:
                prof.stop()
                spans.uninstall()
            record["profile"] = profile.trace_to(prof, rc.workdir)
            inst = Instruments(rc.instruments, clock)
            inst.install()
            try:
                call()
            finally:
                inst.uninstall()
            clock.sync()
            record["calls"] = inst.reduce()
    finally:
        for (m, a), o in zip(saved, originals):
            setattr(m, a, o)
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    readings, levels = check_round(rc, cap, last_call, frames, registered, point2sv, weights, dev)
    shutil.rmtree(rc.workdir, ignore_errors=True)
    return {
        "e2e": {"round_frames_per_s": record["frames"] / record["window_s"], "setup_s": setup_s},
        "record": record,
        "readings": readings,
        "levels": levels,
        "attempted": record["frames"],
        "failed": 0,
        "memory_peak_bytes": peak,
    }


class ReferenceFrames:
    """The reference's 8-view probabilities of the sequence's frames, each
    computed once, on the host; with ``use_tf32`` at TF32 (the control)."""

    def __init__(self, rc, frames, weights, dev, use_tf32: bool = False):
        cfg = rc.config
        self.rc, self.frames, self.dev, self.use_tf32 = rc, frames, dev, use_tf32
        self.model = build(cfg["spvcnn"], cfg["num_classes"], cfg["cs"], cfg["in_channels"]).to(dev)
        self.model.load_state_dict(weights)
        self.model.eval()
        self.cache: Dict[int, np.ndarray] = {}
        self.levels: Dict[int, list] = {}

    def __call__(self, j: int) -> np.ndarray:
        if j not in self.cache:
            xyz, sig, _ = self.frames[j]
            views: list = []
            with tf32(self.use_tf32):
                p = rround.frame_probs(self.model, xyz, sig, self.rc.seed, j, self.rc.config,
                                       self.rc.traffic["inf_reps"], self.dev, views)
            self.cache[j] = p[: len(xyz)].cpu().numpy()
            self.levels[j] = views
        return self.cache[j]

    def sv_scores(self, fi: int, registered, point2sv, neighbours=None):
        """Frame ``fi``'s supervoxel divergence and entropy means, scored
        from these probabilities of it and of its 24 neighbours (or of the
        frames ``neighbours``)."""
        n, k = self.rc.traffic["frames"], self.rc.traffic["supervoxels_per_frame"]
        ids = rround.neighbor_ids(fi, n) if neighbours is None else neighbours
        d, e = rround.frame_scores(self(fi), registered[fi], [(self(j), registered[j]) for j in ids])
        return rround.sv_means(d, e, point2sv[fi], k, registered[fi])[:2]


def rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The worst gap against the reference's value or, where that is
    smaller, its median magnitude."""
    scale = max(float(np.median(np.abs(want))), 1e-12)
    return float((np.abs(got - want) / np.maximum(np.abs(want), scale)).max())


def check_round(rc, cap: Capture, last_call: int, frames, registered, point2sv, weights, dev):
    """The round's numbers against the reference (see ``lidal_bench/check.py``)."""
    k = rc.traffic["supervoxels_per_frame"]
    t0 = time.perf_counter()
    first, final = cap.calls[0], cap.calls[last_call]
    mismatch = sum(int((c["flags"] != first["flags"]).sum()) for c in cap.calls[1:])
    ref_flags = rround.select(final["prev"], final["d"], final["e"], final["pnums"], final["centers"], final["tpn"])
    mismatch += int((ref_flags != final["flags"]).sum())
    counts, centres = zip(*(rround.sv_means(np.zeros(len(r)), np.zeros(len(r)), p2s, k, r)[2:]
                            for r, p2s in zip(registered, point2sv)))
    mismatch += int((final["pnums"] != np.concatenate(counts)).sum())
    score_gap = rel_gap(final["centers"], np.concatenate(centres))
    ref = ReferenceFrames(rc, frames, weights, dev)
    sample = sampled_frames(rc)
    prob_gap = max(float(np.abs(cap.probs[f"{fi:06d}"].cpu().numpy()[: len(frames[fi][0])] - ref(fi)).max())
                   for fi in sample)
    fi = sample[0]
    gids = np.arange(fi * k, (fi + 1) * k)
    for got_s, want_s in zip((final["d"][gids], final["e"][gids]), ref.sv_scores(fi, registered, point2sv)):
        score_gap = max(score_gap, rel_gap(got_s, want_s))
    print(f"[reference] frames {sample}, the first scored with its neighbours: {len(ref.cache)} frames x "
          f"{rc.traffic['inf_reps']} views, scored against the window's last call: "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    levels = [{"what": f"frame {fi} view {v}", "voxels": c, "overflow": o}
              for fi in sample for v, (c, o) in enumerate(ref.levels[fi])]
    return {"prob_gap": prob_gap, "score_gap": score_gap, "selection_mismatch": float(mismatch)}, levels
