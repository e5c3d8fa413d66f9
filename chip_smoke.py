#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's MinkUNet eval, train and LiDAL-round paths on an
NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (each prints what it found; any failed check raises, exit code != 0):

1. device: a CUDA card is required; prints its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them, and the torch / CUDA versions.  TF32 is turned off for matmuls and
   cuDNN, so every comparison below is f32 against f32.
2. build: compiles ``lidal_tpu_torch/csrc/*.cu`` with nvcc, one process per
   source, all started together (seconds printed).
3. lookup kernel vs its plain version on the B x 26 rulebook streams of one
   SemanticKITTI-scale batch at every level, plus edge streams: bit-equal.
4. conv kernel vs its plain version at every (K, cin, cout, epilogue, m, n)
   the forward runs: |kernel - plain| <= 1e-4 * max(1, |plain|) elementwise
   (f32 sums in another order); kernel and plain times (CUDA events).
5. the eval slice: ``run_eval`` over B = 4 synthetic SemanticKITTI frames of
   120k points with the full-width MinkUNet (seeded random weights), caps
   ``SK_CONFIG.level_caps``: one warm-up batch, then 3 timed batches; points/s,
   per-level overflow, mIoU and each kernel's launch count in that run.
6. whole forward on one batch, kernel path vs plain path on the card: logits
   within atol = rtol = 1e-3 and argmax agreement >= 0.999 of valid voxels.
7. backward kernel vs its plain version at every (K, c_src, c_dst, c_f, m, n)
   of one full-width train step (B = 5 frames of 120k points, as
   ``SK_CONFIG.batch_size``): dx and dwg within 1e-4 * plain_abs elementwise,
   plain_abs being the plain version on |src|, |w2| and |f| (a reordered
   f32 sum over up to 655k rows; gradients are ~1e-6, so no floor of 1);
   each no further from the plain version in f64 than F64_FACTOR times the
   f32 plain version is; dwg bit-equal across two runs (no atomics); kernel
   and plain times per shape and per step.
8. the train slice: a temporary SemanticKITTI tree of synthetic 120k-point
   frames, ``run_train`` through its loader (``metric_name="full"``,
   ``r_id=1``): one warm-up step, then TIMED_STEPS steps; steps/s, points/s,
   loss per step, per-level overflow, each kernel's launch count in that run;
   where one step's time goes (prepare, forward, backward, optimizer); the
   checkpoint restores into a fresh model equal to the trained one; then 10
   steps on one repeated batch must end below their first loss.
9. one whole train step from one state and one batch.  Under one forward
   (the kernels', deterministic, so every ReLU mask is the same) the
   backward kernel's gradients against the plain backward's: each within
   BWD_TOL of that gradient's max (f32 sums of up to 655k rows in another
   order through ~40 layers of backward, BN's cancellation included).  The
   kernel path against the plain path: loss within 1e-5 relative; BN
   running statistics within 1e-4 * max(1, |plain|); gradients within
   GRAD_WORST of their max, since either f32 forward flips a few ReLUs whose
   input is near 0 (measured on a small step: one flip at level 0 moved a
   gradient by 1.8 % of its max); after the Adam step every parameter within 2 * lr and all
   but 1e-3 of the entries within 1e-2 * lr.

Phases 10-13 share a second temporary SemanticKITTI tree: one sequence of
ROUND_FRAMES frames of 120k points that see ONE static synthetic world from a
moving, turning pose (``poses.txt`` / ``calib.txt`` register them, so
neighbouring frames hold points within 0.1 m of each other), labels,
supervoxel files from a coarse numpy grid, and round-1 flags.

10. ``build_grid`` on the card against ``build_grid`` on the CPU for one
    registered 120k-point frame: every field equal (cells are
    ``floor(xyz / cell)`` with a true f32 division on both).
11. ``nn_band`` kernel vs its plain version at the main-path shape (26 slots x
    131072 queries, the grids of 26 consecutive frames, one of them the
    query): ``d2`` and ``row`` bit-equal on every query; edge cases (an empty
    band, a table of only BIG rows, an exact tie, a pair at 0.1 m -+ 1 ulp);
    kernel ms per launch, mean band length, pairs evaluated, the share of
    points with a match.
12. the LiDAL slice at full width, ``inf_reps = 8``, from one set of seeded
    weights: (a) staged ``run_prob_inference`` -> ``run_lidal_round``; (b)
    fused ``run_fused_lidal_round``.  Prob rows sum to 1 within 1e-4; (a) and
    (b) give identical prob and pred npys, supervoxel scores, statistics and
    ``sv_flag`` files; some supervoxel is selected; ``nn_band``, ``subm_conv``
    and ``lookup_sorted`` each launched in (b).  Frames/s of (b), seconds per
    frame of (a)'s scoring, and where one fused frame's time goes.
13. ``run_active_round`` for ``r_id = 1`` on that tree, a few train steps at
    full width: trains, evaluates, infers and scores, writes round-2 flags.

The launch counts of the JSON record are those of the main paths (the eval
run of phase 5, the train run of phase 8, the fused round of phase 12), each
counted from 0 just before it.  ``bound_ms`` is the least time the card could
take for the same work: the larger of the bytes the function must move (each
input read once, each output written once) over 3.35 TB/s and its operations
over 67 TFLOP/s (f32 outside the tensor cores; integer compares at half that),
counting the work this run's data needs (real (row, tap) pairs of the convs,
evaluated pairs of ``nn_band``).  ``library_ms`` times one PyTorch call that
computes the same function where there is one (``torch.searchsorted`` for the
lookup), used nowhere in the port.  The last two lines of standard output are
the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

SEED = 0
DEVICE = "cuda"
B = 4
N_PTS = 120_000
TIMED_BATCHES = 3
CONV_TOL = 1e-4
LOGIT_TOL = 1e-3
ARGMAX_AGREE = 0.999
TIMED_STEPS = 5
DESCENT_STEPS = 10
F64_FACTOR = 4.0  # a kernel's distance from f64 against the plain version's (phase 7)
BWD_TOL = 1e-3  # backward kernel vs plain under one forward, share of each gradient's max (phase 9)
GRAD_WORST = 0.1  # kernel path vs plain path, share of each gradient's max (phase 9)
LR = 1e-3
ROUND_FRAMES = 30  # frames of the LiDAL round's sequence (a frame has 24 neighbours)
ROUND_STEPS = 3  # train steps of phase 13's round
WORLD_POINTS = 200_000  # points of the static world; each frame sees N_PTS of them
SV_CELL = 10.0  # metres: side of the coarse grid cells that stand in for supervoxels
PROB_SUM_TOL = 1e-4
# NVIDIA H100 SXM data-sheet peaks: HBM bytes/s, f32 FLOP/s outside the tensor
# cores; integer compares are taken at half the f32 rate (64 INT32 lanes per SM
# against 128 FP32 lanes)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_I32 = PEAK_F32 / 2
# raw SemanticKITTI ids of 19 distinct train classes (car, bicycle, ..., traffic-sign)
RAW_IDS = np.array([10, 11, 15, 18, 20, 30, 31, 32, 40, 44, 48, 49, 50, 51, 70, 71, 72, 80, 81], np.uint32)


def synthetic_sk_frame(rng, n):
    """Surface-like LiDAR frame (ground rings + structures) at SemanticKITTI scale."""
    n_g = int(n * 0.6)
    n_w = n - n_g
    r = 2 + 78 * rng.random(n_g) ** 1.5
    th = rng.uniform(0, 2 * np.pi, n_g)
    ground = np.stack([r * np.cos(th), r * np.sin(th), 0.05 * rng.standard_normal(n_g)], 1)
    cx, cy = rng.uniform(-60, 60, (2, 24))
    wi = rng.integers(0, 24, n_w)
    walls = np.stack(
        [
            cx[wi] + rng.normal(scale=2.0, size=n_w),
            cy[wi] + rng.normal(scale=2.0, size=n_w),
            rng.uniform(0, 4, n_w),
        ],
        1,
    )
    xyz = np.concatenate([ground, walls]).astype(np.float32)
    sig = rng.random(n).astype(np.float32)
    return xyz, sig


def make_batch(rng, point_cap, b=B):
    """One loader-style batch dict of b frames, labels in 0..18."""
    xyz = np.zeros((b, point_cap, 3), np.float32)
    sig = np.zeros((b, point_cap), np.float32)
    valid = np.zeros((b, point_cap), bool)
    labels = np.full((b, point_cap), 255, np.int32)
    for i in range(b):
        x, s = synthetic_sk_frame(rng, N_PTS)
        xyz[i, :N_PTS], sig[i, :N_PTS], valid[i, :N_PTS] = x, s, True
        labels[i, :N_PTS] = rng.integers(0, 19, N_PTS)
    return {"xyz": xyz, "sig": sig, "valid": valid, "labels": labels, "trunc_points": 0}


class Bound:
    """Sum of the least times the card could take for a kernel's calls."""

    def __init__(self):
        self.ms = {"bytes": 0.0, "operations": 0.0}

    def add(self, nbytes: float, ops: float, peak_ops: float = PEAK_F32, calls: int = 1) -> float:
        t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * ops / peak_ops
        by = "bytes" if t_bytes >= t_ops else "operations"
        self.ms[by] += calls * max(t_bytes, t_ops)
        return max(t_bytes, t_ops)

    @property
    def total(self) -> float:
        return self.ms["bytes"] + self.ms["operations"]

    @property
    def by(self) -> str:
        """What binds the larger share of the sum."""
        return max(self.ms, key=self.ms.get)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def conv_close(got, want):
    """(within CONV_TOL * max(1, |plain|) everywhere and finite, max |kernel - plain|)."""
    diff = (got - want).abs()
    ok = bool((diff <= CONV_TOL * want.abs().clamp_min(1.0)).all()) and bool(got.isfinite().all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def randomise_bn(model, seed: int) -> None:
    """BN affine and running statistics drawn like tests/ts_oracle.py's, so the
    fused epilogues do real work."""
    import torch

    from lidal_tpu_torch.models.layers import MaskedBatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))


def write_sk_tree(root, rng, n_frames):
    """A SemanticKITTI sequence "00" of synthetic 120k-point frames (.bin and
    .label with raw ids of the 19 train classes) under ``root/sequences``."""
    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "velodyne"))
    os.makedirs(os.path.join(seq, "labels"))
    for i in range(n_frames):
        xyz, sig = synthetic_sk_frame(rng, N_PTS)
        np.concatenate([xyz, sig[:, None]], 1).astype(np.float32).tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
        RAW_IDS[rng.integers(0, len(RAW_IDS), N_PTS)].tofile(os.path.join(seq, "labels", f"{i:06d}.label"))
    return os.path.join(root, "sequences")


def backward_phase(state, tb):
    """7: every conv_dx_dw call of one train step against its plain version.
    Returns (max |kernel - plain|, kernel ms per step, plain ms per step, the
    step's Bound over the real (row, tap) pairs)."""
    import torch

    from lidal_tpu_torch.ops import cuda_conv_dxdw
    from lidal_tpu_torch.runtime.train import train_step

    captured, calls = {}, {}
    kernel, plain = cuda_conv_dxdw.conv_dx_dw, cuda_conv_dxdw.conv_dx_dw_plain

    def recorder(src, w2, nbr, f, need_dx=True):
        key = (nbr.shape[1], src.shape[1], w2.shape[2], f.shape[1], nbr.shape[0], src.shape[0], bool(need_dx))
        calls[key] = calls.get(key, 0) + 1
        if key not in captured:
            captured[key] = (src.clone(), w2.clone(), nbr.clone(), f.clone(), bool(need_dx))
        return kernel(src, w2, nbr, f, need_dx)

    cuda_conv_dxdw.conv_dx_dw = recorder
    try:
        train_step(state, tb)
    finally:
        cuda_conv_dxdw.conv_dx_dw = kernel
    err = k_total = p_total = 0.0
    least = Bound()
    for key in sorted(captured):
        args = captured[key]
        src, w2, nbr, f, need_dx = args
        dx, dwg = kernel(*args)
        pairs = int((nbr < src.shape[0]).sum())
        b_ms = least.add(
            nbytes(src, w2, nbr, f, dx, dwg),
            2.0 * pairs * src.shape[1] * ((w2.shape[2] if need_dx else 0) + f.shape[1]),
            calls=calls[key],
        )
        _, dwg2 = kernel(*args)
        want = plain(*args)
        ref = plain(src.double(), w2.double(), nbr, f.double(), need_dx)
        bound = plain(src.abs(), w2.abs(), nbr, f.abs(), need_dx)
        require(torch.equal(dwg, dwg2), f"conv_dx_dw {key}: dwg differs between two runs")
        e, notes = 0.0, []
        for name, got, p, r, b in zip(("dx", "dwg"), (dx, dwg), want, ref, bound):
            if got is None:
                continue
            d = (got - p).abs()
            require(bool(got.isfinite().all()) and bool((d <= CONV_TOL * b).all()),
                    f"conv_dx_dw {key}: {name} max |kernel - plain| {float(d.max())}")
            e_k = float((got.double() - r).abs().max())
            e_p = float((p.double() - r).abs().max())
            require(e_k <= F64_FACTOR * e_p + 1e-6 * float(b.max()),
                    f"conv_dx_dw {key}: {name} {e_k:.2e} from f64 against the plain version's {e_p:.2e}")
            e = max(e, float(d.max()))
            notes.append(f"{name} from f64 {e_k:.1e} (plain {e_p:.1e})")
        err = max(err, e)
        k_ms = cuda_ms(lambda: kernel(*args))
        p_ms = cuda_ms(lambda: plain(*args), reps=3)
        k_total += calls[key] * k_ms
        p_total += calls[key] * p_ms
        k, c_src, c_dst, c_f, m, n, _ = key
        print(f"[7 backward] K={k} c_src={c_src} c_dst={c_dst} c_f={c_f} m={m} n={n} dx={int(need_dx)} "
              f"x{calls[key]}: max|d|={e:.2e}, {', '.join(notes)}, dwg bit-equal across runs; "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms ({pairs} real pairs)")
    print(f"[7 backward] {len(captured)} shapes, {sum(calls.values())} calls per train step; per step: "
          f"kernel {k_total:.1f} ms, plain {p_total:.1f} ms, bound {least.total:.2f} ms (by {least.by})")
    return err, k_total, p_total, least


def step_split(state, batch, gen, caps, dev):
    """Milliseconds of one train step's prepare (h2d + augment + voxelize +
    plan), forward + loss, backward and optimizer, by CUDA events."""
    import torch

    from lidal_tpu_torch.data.pipeline import prepare_train_batch
    from lidal_tpu_torch.runtime.train import cross_entropy_ignore

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    tb = prepare_train_batch(
        gen, *(torch.as_tensor(batch[k]).to(dev) for k in ("xyz", "sig", "valid", "labels")), level_caps=caps
    )
    ev[1].record()
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss = cross_entropy_ignore(state.model(tb.feats, tb.plan)[0], tb.labels)
    ev[2].record()
    loss.backward()
    ev[3].record()
    state.optimizer.step()
    state.step += 1
    ev[4].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)], tb


def train_slice_phase(cfg, dev, caps):
    """8: run_train through its loader; returns (the trained state, a batch,
    each kernel's launches in the run)."""
    import torch

    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.ops import cuda_conv, cuda_conv_dxdw, cuda_merge
    from lidal_tpu_torch.runtime import checkpoint as ckpt
    from lidal_tpu_torch.runtime.train import train_step
    from lidal_tpu_torch.runtime.train_loop import build_train_loader, init_state, run_train

    b_train = cfg.data.batch_size
    times, losses = [], []

    def on_step(step, loss):
        losses.append(float(loss))  # waits for the step to finish
        times.append(time.perf_counter())

    for mod in (cuda_merge, cuda_conv, cuda_conv_dxdw):
        mod.LAUNCHES = 0
    state = run_train(cfg, max_iter=1 + TIMED_STEPS, log_every=1, on_step=on_step, device=dev)
    launches = {"lookup_sorted": cuda_merge.LAUNCHES, "subm_conv": cuda_conv.LAUNCHES,
                "conv_dx_dw": cuda_conv_dxdw.LAUNCHES}
    require(state.step == 1 + TIMED_STEPS, f"run_train took {state.step} steps")
    require(all(v > 0 for v in launches.values()), f"a kernel of the train path never launched: {launches}")
    require(all(np.isfinite(x) for x in losses), f"losses {losses}")
    seconds = times[-1] - times[0]
    print(f"[8 slice] run_train: {TIMED_STEPS} steps of {b_train} x {N_PTS}-point frames after 1 warm-up in "
          f"{seconds:.3f} s = {TIMED_STEPS / seconds:.3f} steps/s = {TIMED_STEPS * b_train * N_PTS / seconds:,.0f} "
          f"points/s; losses {[round(x, 4) for x in losses]}; launches {launches}")

    path = ckpt.ckpt_path(Paths(cfg).ckpt_dir())
    require(os.path.exists(path), f"no checkpoint at {path}")
    fresh = init_state(dataclasses.replace(cfg, seed=cfg.seed + 1), dev)
    require(ckpt.restore_checkpoint(Paths(cfg).ckpt_dir(), fresh) is not None, "checkpoint did not restore")
    trained = state.model.state_dict()
    same = all(torch.equal(v, trained[k]) for k, v in fresh.model.state_dict().items())
    require(same and fresh.step == state.step, "the restored model differs from the trained one")
    print(f"[8 slice] checkpoint {os.path.basename(path)} restores a fresh model equal to the trained one "
          f"(step {fresh.step}, {len(trained)} tensors)")

    batch = next(iter(build_train_loader(cfg, shuffle=False)))
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    split = np.mean([step_split(fresh, batch, gen, caps, dev)[0] for _ in range(3)], axis=0)
    _, tb = step_split(fresh, batch, gen, caps, dev)
    print(f"[8 slice] one step (CUDA events, mean of 3): prepare {split[0]:.1f} ms, forward {split[1]:.1f} ms, "
          f"backward {split[2]:.1f} ms, optimizer {split[3]:.1f} ms; overflow per level "
          f"{tb.overflow.sum(dim=0).tolist()}")

    descent = [float(train_step(fresh, tb)) for _ in range(DESCENT_STEPS)]
    require(descent[-1] < descent[0], f"no descent over {DESCENT_STEPS} steps on one batch: {descent}")
    print(f"[8 slice] {DESCENT_STEPS} steps on one batch: loss {descent[0]:.4f} -> {descent[-1]:.4f}")
    return state, tb, launches


def train_step_parity_phase(state, tb):
    """9: one train step from the same state and batch, kernel path vs plain
    path, and the backward kernel against its plain version under one forward."""
    import torch

    from lidal_tpu_torch.ops import cuda_conv, cuda_conv_dxdw
    from lidal_tpu_torch.runtime.train import cross_entropy_ignore, make_optimizer

    def run(plain_forward, plain_backward):
        model = copy.deepcopy(state.model).train()
        opt = make_optimizer(model, lr=LR)
        # load_state_dict keeps tensors that are already on the right device:
        # copy them, or one run's step would move the next run's start
        opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
        kernels = cuda_conv.subm_conv, cuda_conv_dxdw.conv_dx_dw
        if plain_forward:
            cuda_conv.subm_conv = cuda_conv.subm_conv_plain
        if plain_backward:
            cuda_conv_dxdw.conv_dx_dw = cuda_conv_dxdw.conv_dx_dw_plain
        try:
            opt.zero_grad(set_to_none=True)
            loss = cross_entropy_ignore(model(tb.feats, tb.plan)[0], tb.labels)
            loss.backward()
        finally:
            cuda_conv.subm_conv, cuda_conv_dxdw.conv_dx_dw = kernels
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        stats = {n: b.clone() for n, b in model.named_buffers()}
        opt.step()
        return float(loss.detach()), grads, stats, {n: p.detach().clone() for n, p in model.named_parameters()}

    def share_of_max(got, want):
        return {n: float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30) for n, w in want.items()}

    loss, grads, stats, params = run(False, False)
    loss_p, grads_p, stats_p, params_p = run(True, True)
    _, grads_b, _, _ = run(False, True)  # the kernels' forward, the plain backward
    require(abs(loss - loss_p) <= 1e-5 * abs(loss_p), f"loss {loss} vs plain {loss_p}")
    require(all(bool(g.isfinite().all()) for g in grads.values()), "non-finite gradients")
    bwd = share_of_max(grads, grads_b)
    worst = max(bwd, key=bwd.get)
    require(bwd[worst] <= BWD_TOL, f"backward kernel vs plain under one forward: {worst} {bwd[worst]:.2e} of its max")
    path = share_of_max(grads, grads_p)
    worst_p = max(path, key=path.get)
    require(path[worst_p] <= GRAD_WORST, f"gradient {worst_p}: {path[worst_p]:.2e} of its max from the plain path")
    s_err = 0.0
    for name, want in stats_p.items():
        d = (stats[name] - want).abs()
        require(bool((d <= 1e-4 * want.abs().clamp_min(1.0)).all()), f"BN statistic {name}: {float(d.max())}")
        s_err = max(s_err, float(d.max()))
    far = total = 0
    for name, want in params_p.items():
        d = (params[name] - want).abs()
        require(float(d.max()) <= 2 * LR, f"parameter {name} after Adam: {float(d.max())}")
        far += int((d > 1e-2 * LR).sum())
        total += d.numel()
    require(far <= 1e-3 * total, f"{far} of {total} parameters differ by more than 1e-2 * lr after Adam")
    print(f"[9 train step] loss: kernels {loss:.7f}, plain {loss_p:.7f}; under one forward the backward kernel's "
          f"gradients are within {bwd[worst]:.2e} of each one's max of the plain backward's (tol {BWD_TOL}; "
          f"worst {worst}); whole paths: worst {path[worst_p]:.2e} ({worst_p}, tol {GRAD_WORST}), median "
          f"{float(np.median(list(path.values()))):.2e}; BN statistics max|d| {s_err:.2e}; after Adam {far} of "
          f"{total} parameters beyond 1e-2 * lr")


def write_round_tree(root, rng, cfg):
    """A SemanticKITTI sequence "00" whose ROUND_FRAMES frames see ONE static
    world (WORLD_POINTS points, a label each) from a pose that moves 0.5 m and
    turns 0.5 degrees per frame: each frame is N_PTS of the world's points in
    its own sensor coordinates with 1 cm of range noise.  ``calib.txt`` holds a
    KITTI-like ``Tr`` and ``poses.txt`` the camera poses that register the
    frames.  A second sequence "08" of 2 unrelated frames is the val split.
    Also writes each train frame's supervoxel file (cells of a SV_CELL grid over
    the registered x, y) and round-1 flags (every third frame fully labelled).
    Returns the number of supervoxels."""
    from lidal_tpu_torch.data.selection import save_sv_info
    from lidal_tpu_torch.prep.poses import transform_points
    from lidal_tpu_torch.runtime.paths import Paths, ensure_dir

    world, _ = synthetic_sk_frame(rng, WORLD_POINTS)
    world = world.astype(np.float64) + np.array([7.0, 0.0, 0.0])
    world_raw = RAW_IDS[rng.integers(0, len(RAW_IDS), WORLD_POINTS)]
    tr = np.eye(4)
    tr[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]  # velodyne -> camera axes, as KITTI's Tr
    tr[:3, 3] = [0.0, -0.08, -0.27]
    seq = os.path.join(cfg.data_root, "00")
    os.makedirs(os.path.join(seq, "velodyne"))
    os.makedirs(os.path.join(seq, "labels"))
    paths = Paths(cfg)
    svi_dir = ensure_dir(paths.supervoxel_dir("00", "KMeans"))
    flag_dir = ensure_dir(paths.sv_flag_dir("00", r_id=1))
    cam_poses, gid = [], 0
    for i in range(ROUND_FRAMES):
        yaw = np.deg2rad(0.5 * i)
        pose = np.eye(4)  # the sensor in the world
        pose[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
        pose[:3, 3] = [0.5 * i, 0.02 * i, 0.0]
        cam_poses.append(tr @ pose @ np.linalg.inv(tr))
        seen = np.sort(rng.choice(WORLD_POINTS, N_PTS, replace=False))
        xyz = transform_points(world[seen], np.linalg.inv(pose)) + 0.01 * rng.standard_normal((N_PTS, 3))
        sig = rng.random(N_PTS)
        np.concatenate([xyz, sig[:, None]], 1).astype(np.float32).tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
        world_raw[seen].tofile(os.path.join(seq, "labels", f"{i:06d}.label"))
        cells = np.floor(world[seen][:, :2] / SV_CELL).astype(np.int64)
        _, point2sv = np.unique(cells[:, 0] * 100_000 + cells[:, 1], return_inverse=True)
        n_sv = int(point2sv.max()) + 1
        save_sv_info(os.path.join(svi_dir, f"{i:06d}.npz"), point2sv, np.arange(gid, gid + n_sv))
        np.save(os.path.join(flag_dir, f"{i:06d}.npy"), np.full(n_sv, int(i % 3 == 0), np.int32))
        gid += n_sv
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for key in ("P0", "P1", "P2", "P3"):
            f.write(f"{key}: " + " ".join(f"{v:.12e}" for v in np.eye(4)[:3].reshape(-1)) + "\n")
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in tr[:3].reshape(-1)) + "\n")
    with open(os.path.join(seq, "poses.txt"), "w") as f:
        for pose in cam_poses:
            f.write(" ".join(f"{v:.12e}" for v in pose[:3].reshape(-1)) + "\n")
    val = os.path.join(cfg.data_root, "08")
    os.makedirs(os.path.join(val, "velodyne"))
    os.makedirs(os.path.join(val, "labels"))
    for i in range(2):
        xyz, sig = synthetic_sk_frame(rng, N_PTS)
        np.concatenate([xyz, sig[:, None]], 1).astype(np.float32).tofile(os.path.join(val, "velodyne", f"{i:06d}.bin"))
        RAW_IDS[rng.integers(0, len(RAW_IDS), N_PTS)].tofile(os.path.join(val, "labels", f"{i:06d}.label"))
    return gid


def grid_phase(cfg, dev):
    """10: build_grid on the card == build_grid on the CPU, field by field."""
    import torch

    from lidal_tpu_torch.active import lidal
    from lidal_tpu_torch.active.nn_match import build_grid
    from lidal_tpu_torch.prep.grid import load_grid_points
    from lidal_tpu_torch.runtime.paths import Paths

    xyz = load_grid_points(os.path.join(Paths(cfg).grid_dir("00"), f"{ROUND_FRAMES // 2:06d}.npz")).astype(np.float32)
    require(xyz.shape == (N_PTS, 3), f"registered frame {xyz.shape}")
    pad = np.zeros((cfg.data.point_cap, 3), np.float32)
    pad[:N_PTS] = xyz
    valid = np.arange(cfg.data.point_cap) < N_PTS
    with torch.inference_mode():
        on_cpu = build_grid(torch.from_numpy(pad), torch.from_numpy(valid), lidal.DIS_THRESH)
        on_card = build_grid(torch.from_numpy(pad).to(dev), torch.from_numpy(valid).to(dev), lidal.DIS_THRESH)
    for name, a, b in zip(on_cpu._fields, on_card, on_cpu):
        require(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b), f"build_grid field {name} differs")
    cells = int((torch.diff(on_cpu.key_hi[:N_PTS]) != 0).sum() + 1)
    print(f"[10 grid] build_grid of one registered {N_PTS}-point frame (cap {on_cpu.key_hi.shape[0]}): card == CPU on "
          f"{', '.join(on_cpu._fields)}; {cells} distinct x cells of {lidal.DIS_THRESH} m")


def nn_band_phase(cfg, dev):
    """11: the nn_band kernel against its plain version at the main-path shape
    and on edge cases.  Returns the kernel's record fields."""
    import torch

    from lidal_tpu_torch.active import lidal, nn_match
    from lidal_tpu_torch.ops import cuda_nnband
    from lidal_tpu_torch.prep.grid import load_grid_points
    from lidal_tpu_torch.runtime.paths import Paths

    cap, slots = cfg.data.point_cap, lidal.NEI_NUM + 2
    grid_dir = Paths(cfg).grid_dir("00")
    valid = torch.arange(cap, device=dev) < N_PTS
    grids = []
    with torch.inference_mode():
        for i in range(slots):
            pad = np.zeros((cap, 3), np.float32)
            pad[:N_PTS] = load_grid_points(os.path.join(grid_dir, f"{i:06d}.npz"))
            grids.append(nn_match.build_grid(torch.from_numpy(pad).to(dev), valid, lidal.DIS_THRESH))
        q_slot = slots // 2
        pq = nn_match.prepared_from_grid(grids[q_slot])
        grids = nn_match.stack_grids(grids)
        blo, nb = nn_match.band_bounds(grids, pq)
        args = (grids.planar, pq.q_t, blo, nb)
        require(grids.planar.shape == (slots, 3, cap) and pq.q_t.shape == (3, cap), "main-path shape")
        before = cuda_nnband.LAUNCHES
        d2, row = cuda_nnband.nn_band(*args)
        torch.cuda.synchronize()
        require(cuda_nnband.LAUNCHES == before + 1, "nn_band did not count its launch")
        t0 = time.perf_counter()
        d2_p, row_p = cuda_nnband.nn_band_plain(*args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        bad = int((d2 != d2_p).sum()), int((row != row_p).sum())
        require(bad == (0, 0), f"nn_band: {bad[0]} d2 and {bad[1]} row values differ from the plain version")
        err = float((d2 - d2_p).abs().nan_to_num(0.0, 0.0, 0.0).max())  # inf - inf where both bands are empty
        k_ms = cuda_ms(lambda: cuda_nnband.nn_band(*args))
        p_ms = cuda_ms(lambda: cuda_nnband.nn_band_plain(*args), reps=1, warmup=0)

        others = torch.arange(slots, device=dev) != q_slot
        matched = (torch.sqrt(d2) <= torch.full((), lidal.DIS_THRESH, device=dev)) & pq.s_ok
        share = float(matched[others].any(dim=0).sum()) / N_PTS
        per_slot = float(matched[others].float().sum(dim=1).mean()) / N_PTS
        require(share > 0, "no point of the query frame has a match in any neighbour")
        band_rows = float(nb.float().mean()) * cuda_nnband.TN
        pairs = int(nb.long().sum()) * cuda_nnband.TN * cuda_nnband.TILE
        bound = Bound()
        # per pair: 3 subtractions, 3 products, 2 sums (the compare and select are not counted)
        bound.add(nbytes(*args, d2, row), 8.0 * pairs)
        print(f"[11 nn_band] {slots} slots x {cap} queries on tables of {cap} rows: d2 and row bit-equal to the plain "
              f"version on all {d2.numel()} (slot, query) pairs (plain took {plain_s:.1f} s the first time); kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.1f} ms, bound {bound.total:.3f} ms (by {bound.by}); mean band "
              f"{band_rows:.0f} rows per (slot, tile), {pairs:.3e} pairs per launch = "
              f"{pairs / (k_ms * 1e-3):.3e} pairs/s; {share:.4f} of the query frame's points match in some neighbour, "
              f"{per_slot:.4f} in one neighbour on average")

        # edge cases: an empty band, only BIG rows, an exact tie, a pair at 0.1 m -+ 1 ulp
        e_cap, e_p = 2 * cuda_nnband.TN, cuda_nnband.TILE
        tbl = torch.full((4, 3, e_cap), cuda_nnband.BIG_COORD)
        tbl[1, :, 1030] = torch.tensor([0.05, 0.0, 0.0])
        tbl[1, :, 3] = torch.tensor([-0.05, 0.0, 0.0])
        tbl[1, :, 900] = torch.tensor([0.0, 0.05, 0.0])
        below, above = np.nextafter(np.float32(0.1), np.float32(0)), np.nextafter(np.float32(0.1), np.float32(1))
        tbl[2, 0, 5], tbl[2, 1:, 5] = float(below), 0.0
        tbl[3, 0, 5], tbl[3, 1:, 5] = float(above), 0.0
        e_args = [t.to(dev) for t in (tbl, torch.zeros((3, e_p)), torch.zeros((4, 1), dtype=torch.int32),
                                      torch.tensor([[0], [2], [1], [1]], dtype=torch.int32))]
        e_d2, e_row = cuda_nnband.nn_band(*e_args)
        p_d2, p_row = cuda_nnband.nn_band_plain(*e_args)
        require(torch.equal(e_d2, p_d2) and torch.equal(e_row, p_row), "nn_band edge cases differ from the plain version")
        require(bool(torch.isinf(e_d2[0]).all()) and not bool(e_row[0].any()), "empty band must give (inf, 0)")
        require(int(e_row[1, 0]) == 3, f"tie: row {int(e_row[1, 0])} won, not the lowest (3)")
        thresh = torch.full((), lidal.DIS_THRESH, device=dev)
        require(bool(torch.sqrt(e_d2[2, 0]) <= thresh) and not bool(torch.sqrt(e_d2[3, 0]) <= thresh),
                "the pair 1 ulp below 0.1 m must match and the pair 1 ulp above must not")
        big = [e_args[0][:1].contiguous(), e_args[1], e_args[2][:1].contiguous(),
               torch.full((1, 1), 2, dtype=torch.int32, device=dev)]
        b_d2, b_row = cuda_nnband.nn_band(*big)
        require(torch.equal(b_d2, cuda_nnband.nn_band_plain(*big)[0]) and bool(torch.isfinite(b_d2).all())
                and not bool(b_row.any()), "a table of only BIG rows")
        print("[11 nn_band] edge cases bit-equal: empty band -> (inf, 0); only BIG rows; tie -> lowest row; "
              "0.1 m - 1 ulp matches, + 1 ulp does not")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound.total, "bound_by": bound.by}


def lidal_slice_phase(cfg, root, dev, n_sv):
    """12: staged and fused LiDAL rounds from the same weights; returns the
    kernels' launches in the fused round."""
    import torch

    from lidal_tpu_torch.active import lidal, lidal_runner
    from lidal_tpu_torch.active.nn_match import HashGrid, band_bounds, prepared_from_grid
    from lidal_tpu_torch.data import semantic_kitti as sk
    from lidal_tpu_torch.data.pipeline import pad_points
    from lidal_tpu_torch.ops import cuda_conv, cuda_merge, cuda_nnband
    from lidal_tpu_torch.prep.grid import load_grid_points
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.prob_inference import frame_generator, make_multiview_fn, run_prob_inference
    from lidal_tpu_torch.runtime.train_loop import init_state

    model = init_state(cfg, dev).model.eval()
    randomise_bn(model, SEED + 7)
    files = sk.list_frames(cfg.data_root, cfg.data.train_split)
    require(len(files) == ROUND_FRAMES, f"{len(files)} train frames")
    frame_index = {sk.frame_id(p): i for i, p in enumerate(files)}
    by_id = {sk.frame_id(p): p for p in files}
    tpn = cfg.data.train_point_num

    # the fused round gets its own copy of the prepared tree, so that the two
    # rounds' artifacts can be compared file by file
    cfg_f = dataclasses.replace(cfg, processing_root=os.path.join(root, "Processing_fused"))
    shutil.copytree(cfg.processing_root, cfg_f.processing_root)

    selections = []
    select = lidal.select

    def recording_select(*args, **kwargs):
        selections.append([np.array(a) for a in args[:5]])
        return select(*args, **kwargs)

    lidal.select = recording_select
    try:
        # (a) staged
        inf_cfg = lidal_runner._prev_cfg(cfg)
        t0 = time.perf_counter()
        run_prob_inference(inf_cfg, model, files, lambda p: sk.read_frame(p, with_labels=False), sk.frame_id, device=dev)
        torch.cuda.synchronize()
        t_inf = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_a = lidal_runner.run_lidal_round(cfg, device=dev)
        t_score = time.perf_counter() - t0
        # (b) fused: the main path of this slice
        for mod in (cuda_merge, cuda_conv, cuda_nnband):
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        res_b = lidal_runner.run_fused_lidal_round(
            cfg_f, model, lambda seq, name: sk.read_frame(by_id[(seq, name)], with_labels=False)[:2],
            frame_index=frame_index, device=dev,
        )
        t_fused = time.perf_counter() - t0
        launches = {"lookup_sorted": cuda_merge.LAUNCHES, "subm_conv": cuda_conv.LAUNCHES, "nn_band": cuda_nnband.LAUNCHES}
    finally:
        lidal.select = select
    require(all(v > 0 for v in launches.values()), f"a kernel of the fused round never launched: {launches}")
    require(launches["nn_band"] == ROUND_FRAMES, f"nn_band launched {launches['nn_band']} times for {ROUND_FRAMES} frames")

    # identical artifacts, scores and selections
    pa, pb = Paths(lidal_runner._prev_cfg(cfg)), Paths(lidal_runner._prev_cfg(cfg_f))
    worst_sum = 0.0
    for i in range(ROUND_FRAMES):
        name = f"{i:06d}"
        prob_a = np.load(os.path.join(pa.prob_dir("00"), f"{name}.npy"))
        require(prob_a.shape == (N_PTS, cfg.data.num_classes) and prob_a.dtype == np.float32, f"prob {prob_a.shape}")
        require(bool(np.isfinite(prob_a).all()), f"non-finite prob in frame {name}")
        worst_sum = max(worst_sum, float(np.abs(prob_a.sum(1) - 1.0).max()))
        require(np.array_equal(prob_a, np.load(os.path.join(pb.prob_dir("00"), f"{name}.npy"))), f"prob {name}: staged != fused")
        pred_a = np.load(os.path.join(pa.pred_dir("00"), f"{name}.npy"))
        require(pred_a.dtype == np.int32 and np.array_equal(pred_a, prob_a.argmax(1)), f"pred {name}")
        require(np.array_equal(pred_a, np.load(os.path.join(pb.pred_dir("00"), f"{name}.npy"))), f"pred {name}: staged != fused")
        flag_a = np.load(os.path.join(Paths(cfg).sv_flag_dir("00"), f"{name}.npy"))
        flag_b = np.load(os.path.join(Paths(cfg_f).sv_flag_dir("00"), f"{name}.npy"))
        require(np.array_equal(flag_a, flag_b), f"sv_flag {name}: staged != fused")
    require(worst_sum <= PROB_SUM_TOL, f"prob rows sum to 1 within {worst_sum}")
    require(len(selections) == 2 and all(np.array_equal(a, b) for a, b in zip(*selections)),
            "supervoxel flags, scores, point counts or centres differ between the staged and the fused round")
    for a, b in zip(res_a, res_b):
        require(np.array_equal(a, b), "selections differ between the staged and the fused round")
    _, sv_interds, sv_interes, sv_pnums, _ = selections[0]
    require(len(sv_interds) == n_sv and bool(np.isfinite(sv_interds).all()) and bool(np.isfinite(sv_interes).all()),
            "supervoxel scores")
    require(len(res_b.al_added) > 0 and len(res_b.sl_added) > 0, "no supervoxel was selected")
    print(f"[12 slice] staged: run_prob_inference {ROUND_FRAMES} frames x {cfg.inf_reps} views in {t_inf:.2f} s "
          f"({ROUND_FRAMES / t_inf:.3f} frames/s), run_lidal_round in {t_score:.2f} s = {t_score / ROUND_FRAMES:.4f} "
          f"s/frame of scoring (npy load, ring insert, nn_band, accumulation, aggregate, selection)")
    print(f"[12 slice] fused: run_fused_lidal_round in {t_fused:.2f} s = {ROUND_FRAMES / t_fused:.3f} frames/s "
          f"(staged total {ROUND_FRAMES / (t_inf + t_score):.3f} frames/s); launches {launches}")
    print(f"[12 slice] staged == fused: {ROUND_FRAMES} prob and pred npys, {n_sv} supervoxel scores, statistics and "
          f"sv_flag files identical; prob rows sum to 1 within {worst_sum:.1e}; {int((sv_interds > 0).sum())} of {n_sv} "
          f"supervoxels have divergence > 0; selected {len(res_b.al_added)} for labels ({int(sv_pnums[res_b.al_added].sum())} "
          f"points of a budget of {round(0.01 * tpn)}) and {len(res_b.sl_added)} for pseudo labels")

    # where one fused frame's time goes
    with torch.inference_mode():
        fn = make_multiview_fn(lidal_runner._prev_cfg(cfg), model, with_feat=False)
        mid = ROUND_FRAMES // 2
        xyz_raw, sig, _ = sk.read_frame(files[mid], with_labels=False)
        frame = [torch.from_numpy(a).to(dev) for a in pad_points(xyz_raw, sig, None, cfg.data.point_cap)[:3]]
        t_infer = cuda_ms(lambda: fn(frame_generator(cfg.seed, mid), *frame), reps=3)
        prob = fn(frame_generator(cfg.seed, mid), *frame)[0]
        ring = lidal_runner.NeighborRing(lidal.NEI_NUM + 2, cfg.data.point_cap, device=dev)
        gxyz = {i: load_grid_points(os.path.join(Paths(cfg).grid_dir("00"), f"{i:06d}.npz")).astype(np.float32)
                for i in range(lidal.NEI_NUM + 2)}
        ring.ensure(list(gxyz), lambda k: (gxyz[k], prob))
        nei = [k for k in gxyz if k != mid][: lidal.NEI_NUM]
        buf = np.zeros((cfg.data.point_cap, 3), np.float32)
        buf[:N_PTS] = gxyz[0]
        prob0 = torch.where((torch.arange(cfg.data.point_cap, device=dev) < N_PTS)[:, None], prob, 0.0)
        # one frame entering the ring: coords upload, build_grid, slot writes (slot 0 rewritten with itself)
        t_insert = cuda_ms(lambda: ring._insert(ring.key2slot[0], torch.from_numpy(buf).to(dev), N_PTS, prob0), reps=3)
        w = torch.from_numpy(ring.weights(nei)).to(dev)
        t_slot = cuda_ms(lambda: lidal.score_slot(ring.state, ring.key2slot[mid], w), reps=3)
        launches_before = cuda_nnband.LAUNCHES
        pq = prepared_from_grid(HashGrid(*(f[ring.key2slot[mid]] for f in ring.state[0])))
        blo, nb = band_bounds(ring.state[0], pq)
        t_band = cuda_ms(lambda: cuda_nnband.nn_band(ring.state[0].planar, pq.q_t, blo, nb), reps=3)
        cuda_nnband.LAUNCHES = launches_before
        scores = lidal.score_slot(ring.state, ring.key2slot[mid], w).cpu()
    agg = lidal_runner._SvAggregator(cfg, n_sv).make_aggregate("00", 0, Paths(cfg).supervoxel_dir("00", "KMeans"),
                                                                [f"{i:06d}" for i in range(ROUND_FRAMES)], False)
    t0 = time.perf_counter()
    agg(mid, N_PTS, gxyz[mid], scores)
    t_agg = 1e3 * (time.perf_counter() - t0)
    print(f"[12 slice] one fused frame (CUDA events, mean of 3): inference ({cfg.inf_reps} views) {t_infer:.1f} ms, ring "
          f"insert {t_insert:.1f} ms, score_slot {t_slot:.1f} ms of which nn_band {t_band:.1f} ms and band bounds + "
          f"accumulation {t_slot - t_band:.1f} ms; host aggregate {t_agg:.1f} ms (host clock)")
    del model, ring, prob
    torch.cuda.empty_cache()
    return launches


def active_round_phase(cfg, dev):
    """13: run_active_round for r_id = 1: train, evaluate, fused inference +
    scoring; round-2 flags written."""
    from lidal_tpu_torch.runtime.paths import Paths
    from lidal_tpu_torch.runtime.round import run_active_round

    out_dir = Paths(dataclasses.replace(cfg, r_id=2)).sv_flag_dir("00")
    shutil.rmtree(out_dir, ignore_errors=True)  # phase 12's staged round wrote there
    t0 = time.perf_counter()
    out = run_active_round(dataclasses.replace(cfg, r_id=1), 1, evaluate=True, max_iter=ROUND_STEPS, device=dev)
    seconds = time.perf_counter() - t0
    require(0.0 <= out["miou"] <= 1.0, f"mIoU {out['miou']}")
    flags = [np.load(os.path.join(out_dir, f"{i:06d}.npy")) for i in range(ROUND_FRAMES)]
    prev = [np.load(os.path.join(Paths(dataclasses.replace(cfg, r_id=1)).sv_flag_dir("00"), f"{i:06d}.npy"))
            for i in range(ROUND_FRAMES)]
    new_labels = sum(int(((f == 1) & (p != 1)).sum()) for f, p in zip(flags, prev))
    kept = all(bool((f[p == 1] == 1).all()) for f, p in zip(flags, prev))
    require(new_labels > 0 and kept, f"round-2 flags: {new_labels} new labels, earlier labels kept: {kept}")
    print(f"[13 round] run_active_round(r_id=1): {ROUND_STEPS} train steps, eval mIoU {out['miou']:.4f} (random labels), "
          f"fused inference + scoring of {ROUND_FRAMES} frames, {new_labels} supervoxels newly labelled and "
          f"{sum(int((f == 2).sum()) for f in flags)} pseudo-labelled in the round-2 flags; {seconds:.1f} s in all")


def main() -> None:
    import torch

    # ---- 1. device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py drives the port on an NVIDIA GPU")
    from lidal_tpu_torch.config import SK_CONFIG, RunConfig
    from lidal_tpu_torch import kernels_build
    from lidal_tpu_torch.data.pipeline import prepare_eval_batch, prepare_train_batch
    from lidal_tpu_torch.models.minkunet import MinkUNet
    from lidal_tpu_torch.ops import cuda_conv, cuda_merge
    from lidal_tpu_torch.ops.hashing import SENTINEL_KEY, key64
    from lidal_tpu_torch.ops.kernel_map import rulebook_streams
    from lidal_tpu_torch.prep.grid import prepare_sk_grids
    from lidal_tpu_torch.runtime.evaluate import run_eval
    from lidal_tpu_torch.runtime.train_loop import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")

    # ---- 2. build ----------------------------------------------------------------
    sources = ("merge_lookup", "subm_conv", "conv_dx_dw", "nn_band")
    t0 = time.perf_counter()
    kernels_build.load_all(sources)
    print(f"[2 build] {len(sources)} sources, one nvcc each, started together: {time.perf_counter() - t0:.1f} s")
    for name in sources:
        seconds, report = kernels_build.BUILD_LOG[name]
        usage = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[2 build] {name}.cu: {seconds:.1f} s; ptxas: {' | '.join(usage)}")

    cfg = RunConfig(dataset_name="SK", model_name="Mink")
    caps = SK_CONFIG.level_caps
    rng = np.random.default_rng(SEED)
    batches = [make_batch(rng, SK_CONFIG.point_cap) for _ in range(1 + TIMED_BATCHES)]
    b0 = batches[1]

    def prepare(batch, seed):
        return prepare_eval_batch(
            torch.Generator(device="cpu").manual_seed(seed),
            *(torch.as_tensor(batch[k], device=dev) for k in ("xyz", "sig", "valid")),
            level_caps=caps,
        )

    eb = prepare(b0, SEED)
    torch.cuda.synchronize()

    # ---- 3. lookup kernel vs plain ------------------------------------------------
    lookup_err = 0
    lookup_ms = lookup_plain_ms = lookup_lib_ms = 0.0
    lookup_bound = Bound()
    for lvl, lv in enumerate(eb.plan.levels):
        streams = rulebook_streams(lv.coords, lv.valid)
        for found in (True, False):
            got = cuda_merge.lookup_sorted(*streams, with_found=found)
            want = cuda_merge.lookup_sorted_plain(*streams, with_found=found)
            bad = int((got != want).sum())
            lookup_err = max(lookup_err, int((got.long() - want.long()).abs().max()))
            require(bad == 0, f"lookup level {lvl} found={found}: {bad} results differ")
        k_ms = cuda_ms(lambda: cuda_merge.lookup_sorted(*streams, with_found=True))
        p_ms = cuda_ms(lambda: cuda_merge.lookup_sorted_plain(*streams, with_found=True))
        lookup_ms += k_ms
        lookup_plain_ms += p_ms
        # the one library call of the same function: torch.searchsorted over int64 keys
        tk = key64(streams[0], streams[1])
        qk = key64(streams[2], streams[3]).reshape(tk.shape[0], -1)
        lib_ms = cuda_ms(lambda: torch.searchsorted(tk, qk))
        lookup_lib_ms += lib_ms
        n_queries, n_table = streams[2].numel(), streams[0].shape[1]
        b_ms = lookup_bound.add(
            nbytes(*streams) + 4 * n_queries, 2.0 * n_queries * max(1, n_table).bit_length(), PEAK_I32
        )
        del tk, qk
        print(f"[3 lookup] level {lvl}: {streams[2].shape[0]} streams x {streams[2].shape[1]} queries "
              f"on {streams[0].shape[0]} tables, bit-equal (both modes); kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
              f"torch.searchsorted on ready int64 keys {lib_ms:.3f} ms, bound {b_ms:.4f} ms")
    t_hi, t_lo, q_hi, q_lo = rulebook_streams(eb.plan.levels[0].coords, eb.plan.levels[0].valid)
    sent_t = torch.full_like(t_hi, SENTINEL_KEY)
    dup_hi, dup_lo = q_hi.clone(), q_lo.clone()
    dup_hi[:, 1::2], dup_lo[:, 1::2] = dup_hi[:, ::2], dup_lo[:, ::2]  # sorted, every key twice
    edges = {
        "all-sentinel tables": (sent_t, sent_t, q_hi, q_lo),
        "all-sentinel queries": (t_hi, t_lo, torch.full_like(q_hi, SENTINEL_KEY), torch.full_like(q_lo, SENTINEL_KEY)),
        "duplicate queries": (t_hi, t_lo, dup_hi, dup_lo),
        "zero-width tables": (t_hi[:, :0].contiguous(), t_lo[:, :0].contiguous(), q_hi, q_lo),
    }
    for name, streams in edges.items():
        for found in (True, False):
            got = cuda_merge.lookup_sorted(*streams, with_found=found)
            want = cuda_merge.lookup_sorted_plain(*streams, with_found=found)
            require(torch.equal(got, want), f"lookup edge case {name} found={found}")
    print(f"[3 lookup] edge streams bit-equal: {', '.join(edges)}")

    # ---- 4. conv kernel vs plain at every shape of the forward ---------------------
    torch.manual_seed(SEED)
    model = MinkUNet(num_classes=SK_CONFIG.num_classes).eval()
    randomise_bn(model, SEED + 1)
    model = model.to(dev)

    captured, calls = {}, {}
    kernel_conv = cuda_conv.subm_conv

    def recorder(feats, w, nbr, scale=None, shift=None, relu=False):
        key = (nbr.shape[1], feats.shape[1], w.shape[2], relu, nbr.shape[0], feats.shape[0])
        calls[key] = calls.get(key, 0) + 1
        if key not in captured:
            captured[key] = (feats.clone(), w.clone(), nbr.clone(), scale.clone(), shift.clone(), relu)
        return kernel_conv(feats, w, nbr, scale, shift, relu)

    cuda_conv.subm_conv = recorder
    try:
        with torch.inference_mode():
            model(eb.feats, eb.plan)
    finally:
        cuda_conv.subm_conv = kernel_conv

    conv_err = 0.0
    conv_ms = conv_plain_ms = 0.0
    conv_bound = Bound()
    with torch.inference_mode():
        for key in sorted(captured):
            args = captured[key]
            out = cuda_conv.subm_conv(*args)
            ok, err = conv_close(out, cuda_conv.subm_conv_plain(*args))
            pairs = int((args[2] < args[0].shape[0]).sum())  # real (row, tap) pairs
            b_ms = conv_bound.add(nbytes(*args[:5], out), 2.0 * pairs * key[1] * key[2], calls=calls[key])
            del out
            require(ok, f"conv {key}: max |kernel - plain| {err}")
            conv_err = max(conv_err, err)
            k_ms = cuda_ms(lambda: cuda_conv.subm_conv(*args))
            p_ms = cuda_ms(lambda: cuda_conv.subm_conv_plain(*args), reps=3)
            conv_ms += calls[key] * k_ms
            conv_plain_ms += calls[key] * p_ms
            k, cin, cout, relu, m, n = key
            print(f"[4 conv] K={k} cin={cin} cout={cout} relu={int(relu)} m={m} n={n} x{calls[key]}: "
                  f"max|d|={err:.2e}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms "
                  f"({pairs} real pairs)")
        # the no-epilogue form at the widest level-0 shape
        key = max(captured, key=lambda kk: (kk[4], kk[1] * kk[2]))
        feats, w, nbr = captured[key][:3]
        ok, err = conv_close(cuda_conv.subm_conv(feats, w, nbr), cuda_conv.subm_conv_plain(feats, w, nbr))
        require(ok, f"conv without epilogue {key[:3]}: max |kernel - plain| {err}")
    print(f"[4 conv] {len(captured)} shapes, {sum(calls.values())} calls per forward; within "
          f"{CONV_TOL} * max(1, |plain|); per forward: kernel {conv_ms:.1f} ms, plain {conv_plain_ms:.1f} ms, "
          f"bound {conv_bound.total:.2f} ms (by {conv_bound.by})")
    del captured

    # ---- 5. the slice: run_eval ----------------------------------------------------
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    run_eval(cfg, model, batches[:1], dev, gen)  # warm-up
    torch.cuda.synchronize()
    cuda_merge.LAUNCHES = 0
    cuda_conv.LAUNCHES = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = run_eval(cfg, model, batches[1:], dev, gen)
    end.record()
    torch.cuda.synchronize()
    launches = {"lookup_sorted": cuda_merge.LAUNCHES, "subm_conv": cuda_conv.LAUNCHES}
    seconds = start.elapsed_time(end) / 1e3
    require(all(v > 0 for v in launches.values()), f"a kernel of the path never launched: {launches}")
    require(res.points == TIMED_BATCHES * B * N_PTS, f"points evaluated {res.points}")
    require(0.0 <= res.miou <= 1.0 and int(res.confusion.sum()) > 0, f"mIoU {res.miou}")
    print(f"[5 slice] run_eval: {TIMED_BATCHES} batches x {B} frames x {N_PTS} points in {seconds:.3f} s = "
          f"{res.points / seconds:,.0f} points/s; overflow per level {res.overflow.tolist()}; "
          f"mIoU {res.miou:.4f} (random weights); launches {launches}")

    # where one batch's time goes (CUDA events around each stage)
    with torch.inference_mode():
        t_prep = cuda_ms(lambda: prepare(b0, SEED), reps=3)
        t_fwd = cuda_ms(lambda: model(eb.feats, eb.plan), reps=3)
    print(f"[5 slice] one batch: prepare (augment+voxelize+plan) {t_prep:.1f} ms, forward {t_fwd:.1f} ms")

    # ---- 6. whole forward: kernel path vs plain path -----------------------------------
    plain_lookup = cuda_merge.lookup_sorted
    cuda_merge.lookup_sorted = cuda_merge.lookup_sorted_plain
    cuda_conv.subm_conv = cuda_conv.subm_conv_plain
    try:
        eb_p = prepare(b0, SEED)
        with torch.inference_mode():
            logits_p, _ = model(eb_p.feats, eb_p.plan)
    finally:
        cuda_merge.lookup_sorted = plain_lookup
        cuda_conv.subm_conv = kernel_conv
    for lk, lp in zip(eb.plan.levels, eb_p.plan.levels):
        require(torch.equal(lk.nbr3, lp.nbr3), "rulebooks of the kernel and plain paths differ")
    with torch.inference_mode():
        logits, feats = model(eb.feats, eb.plan)
    require(logits.shape == (B, caps[0], SK_CONFIG.num_classes) and feats.shape == (B, caps[0], 96), "shapes")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    valid0 = eb.plan.levels[0].valid
    logit_err = float((logits - logits_p).abs().max())
    require(torch.allclose(logits, logits_p, atol=LOGIT_TOL, rtol=LOGIT_TOL), f"logits differ by {logit_err}")
    agree = float((logits.argmax(-1) == logits_p.argmax(-1))[valid0].float().mean())
    require(agree >= ARGMAX_AGREE, f"argmax agreement {agree}")
    print(f"[6 forward] kernel vs plain path: max|d logits| {logit_err:.2e} (tol {LOGIT_TOL}), argmax agreement "
          f"{agree:.6f} over {int(valid0.sum())} valid voxels; logits std {float(logits[valid0].std()):.3f}")

    # ---- 7-9. training ---------------------------------------------------------------
    del model, eb, eb_p, logits, logits_p, feats
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="lidal_sk_")
    try:
        data = dataclasses.replace(SK_CONFIG, train_split=("00",))
        cfg_train = RunConfig(
            dataset_name="SK", model_name="Mink", label_unit="fr", metric_name="full", r_id=1,
            max_iter=1 + TIMED_STEPS, ckpt_every=10**6, seed=SEED,
            data_root=write_sk_tree(root, np.random.default_rng(SEED + 4), 3 * data.batch_size),
            processing_root=os.path.join(root, "Processing_files"),
            checkpoint_root=os.path.join(root, "check_points"), data_override=data,
        )
        train_state = init_state(cfg_train, dev)
        b7 = make_batch(rng, SK_CONFIG.point_cap, data.batch_size)
        tb7 = prepare_train_batch(
            torch.Generator(device="cpu").manual_seed(SEED + 5),
            *(torch.as_tensor(b7[k], device=dev) for k in ("xyz", "sig", "valid", "labels")),
            level_caps=caps,
        )
        dxdw_err, dxdw_ms, dxdw_plain_ms, dxdw_bound = backward_phase(train_state, tb7)
        del train_state, tb7, b7
        torch.cuda.empty_cache()
        trained, tb8, train_launches = train_slice_phase(cfg_train, dev, caps)
        train_step_parity_phase(trained, tb8)
        del trained, tb8
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 10-13. the LiDAL round -------------------------------------------------------
    root = tempfile.mkdtemp(prefix="lidal_round_")
    try:
        data = dataclasses.replace(
            SK_CONFIG, train_split=("00",), val_split=("08",), train_point_num=ROUND_FRAMES * N_PTS
        )
        cfg_round = RunConfig(
            dataset_name="SK", model_name="Mink", label_unit="sv", metric_name="LiDAL", r_id=2, inf_reps=8,
            ckpt_every=10**6, seed=SEED, data_root=os.path.join(root, "sequences"),
            processing_root=os.path.join(root, "Processing_files"),
            checkpoint_root=os.path.join(root, "check_points"), data_override=data,
        )
        t0 = time.perf_counter()
        n_sv = write_round_tree(root, np.random.default_rng(SEED + 6), cfg_round)
        prepare_sk_grids(cfg_round)
        print(f"[10 grid] a sequence of {ROUND_FRAMES} frames x {N_PTS} points of one static world, {n_sv} supervoxels, "
              f"registered by prepare_sk_grids: {time.perf_counter() - t0:.1f} s")
        grid_phase(cfg_round, dev)
        nn_band = nn_band_phase(cfg_round, dev)
        round_launches = lidal_slice_phase(cfg_round, root, dev, n_sv)
        active_round_phase(cfg_round, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("lookup_sorted", "subm_conv"):
        launches[name] += train_launches[name] + round_launches[name]

    record = {
        "kernels": [
            {
                "name": "lookup_sorted", "route": "cuda", "source": "lidal_tpu_torch/csrc/merge_lookup.cu",
                "replaces": "lidal_tpu/ops/pallas_merge.py:211", "launches": launches["lookup_sorted"],
                "max_abs_err": lookup_err, "ms": lookup_ms, "plain_ms": lookup_plain_ms,
                "bound_ms": lookup_bound.total, "bound_by": lookup_bound.by, "library_ms": lookup_lib_ms,
            },
            {
                "name": "subm_conv", "route": "cuda", "source": "lidal_tpu_torch/csrc/subm_conv.cu",
                "replaces": "lidal_tpu/ops/pallas_conv.py:387", "launches": launches["subm_conv"],
                "max_abs_err": conv_err, "ms": conv_ms, "plain_ms": conv_plain_ms,
                "bound_ms": conv_bound.total, "bound_by": conv_bound.by, "library_ms": None,
            },
            {
                "name": "conv_dx_dw", "route": "cuda", "source": "lidal_tpu_torch/csrc/conv_dx_dw.cu",
                "replaces": "lidal_tpu/ops/pallas_conv.py:299", "launches": train_launches["conv_dx_dw"],
                "max_abs_err": dxdw_err, "ms": dxdw_ms, "plain_ms": dxdw_plain_ms,
                "bound_ms": dxdw_bound.total, "bound_by": dxdw_bound.by, "library_ms": None,
            },
            {
                "name": "nn_band", "route": "cuda", "source": "lidal_tpu_torch/csrc/nn_band.cu",
                "replaces": "lidal_tpu/ops/pallas_nnband.py:158", "launches": round_launches["nn_band"],
                "library_ms": None, **nn_band,
            },
        ]
    }
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
