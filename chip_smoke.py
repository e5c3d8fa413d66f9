#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's MinkUNet eval and train paths on an NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (each prints what it found; any failed check raises, exit code != 0):

1. device: a CUDA card is required; prints its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them, and the torch / CUDA versions.  TF32 is turned off for matmuls and
   cuDNN, so every comparison below is f32 against f32.
2. build: compiles ``lidal_tpu_torch/csrc/*.cu`` with nvcc (seconds printed).
3. lookup kernel vs its plain version on the B x 26 rulebook streams of one
   SemanticKITTI-scale batch at every level, plus edge streams: bit-equal.
4. conv kernel vs its plain version at every (K, cin, cout, epilogue, m, n)
   the forward runs: |kernel - plain| <= 1e-4 * max(1, |plain|) elementwise
   (f32 sums in another order); kernel and plain times (CUDA events).
5. the slice: ``run_eval`` over B = 4 synthetic SemanticKITTI frames of 120k
   points with the full-width MinkUNet (seeded random weights), caps
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

The launch counts of the JSON record are those of the two main paths, the
eval run of phase 5 and the train run of phase 8, each counted from 0 just
before it.  The last two lines of standard output are the kernels' JSON
record and ``{"ok": true, "device": {...}}``.
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
    Returns (max |kernel - plain|, kernel ms per step, plain ms per step)."""
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
    for key in sorted(captured):
        args = captured[key]
        src, w2, nbr, f, need_dx = args
        dx, dwg = kernel(*args)
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
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
    print(f"[7 backward] {len(captured)} shapes, {sum(calls.values())} calls per train step; per step: "
          f"kernel {k_total:.1f} ms, plain {p_total:.1f} ms")
    return err, k_total, p_total


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

    from lidal_tpu.runtime.paths import Paths
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


def main() -> None:
    import torch

    # ---- 1. device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py drives the port on an NVIDIA GPU")
    from lidal_tpu.config import SK_CONFIG, RunConfig
    from lidal_tpu_torch import kernels_build
    from lidal_tpu_torch.data.pipeline import prepare_eval_batch, prepare_train_batch
    from lidal_tpu_torch.models.minkunet import MinkUNet
    from lidal_tpu_torch.ops import cuda_conv, cuda_merge
    from lidal_tpu_torch.ops.hashing import SENTINEL_KEY
    from lidal_tpu_torch.ops.kernel_map import rulebook_streams
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
    for name in ("merge_lookup", "subm_conv", "conv_dx_dw"):
        kernels_build.load(name)
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
    lookup_ms = lookup_plain_ms = 0.0
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
        print(f"[3 lookup] level {lvl}: {streams[2].shape[0]} streams x {streams[2].shape[1]} queries "
              f"on {streams[0].shape[0]} tables, bit-equal (both modes); kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
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
    with torch.inference_mode():
        for key in sorted(captured):
            args = captured[key]
            ok, err = conv_close(cuda_conv.subm_conv(*args), cuda_conv.subm_conv_plain(*args))
            require(ok, f"conv {key}: max |kernel - plain| {err}")
            conv_err = max(conv_err, err)
            k_ms = cuda_ms(lambda: cuda_conv.subm_conv(*args))
            p_ms = cuda_ms(lambda: cuda_conv.subm_conv_plain(*args), reps=3)
            conv_ms += calls[key] * k_ms
            conv_plain_ms += calls[key] * p_ms
            k, cin, cout, relu, m, n = key
            print(f"[4 conv] K={k} cin={cin} cout={cout} relu={int(relu)} m={m} n={n} x{calls[key]}: "
                  f"max|d|={err:.2e}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        # the no-epilogue form at the widest level-0 shape
        key = max(captured, key=lambda kk: (kk[4], kk[1] * kk[2]))
        feats, w, nbr = captured[key][:3]
        ok, err = conv_close(cuda_conv.subm_conv(feats, w, nbr), cuda_conv.subm_conv_plain(feats, w, nbr))
        require(ok, f"conv without epilogue {key[:3]}: max |kernel - plain| {err}")
    print(f"[4 conv] {len(captured)} shapes, {sum(calls.values())} calls per forward; within "
          f"{CONV_TOL} * max(1, |plain|); per forward: kernel {conv_ms:.1f} ms, plain {conv_plain_ms:.1f} ms")
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
        dxdw_err, dxdw_ms, dxdw_plain_ms = backward_phase(train_state, tb7)
        del train_state, tb7, b7
        torch.cuda.empty_cache()
        trained, tb8, train_launches = train_slice_phase(cfg_train, dev, caps)
        train_step_parity_phase(trained, tb8)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("lookup_sorted", "subm_conv"):
        launches[name] += train_launches[name]

    record = {
        "kernels": [
            {
                "name": "lookup_sorted", "route": "cuda", "source": "lidal_tpu_torch/csrc/merge_lookup.cu",
                "replaces": "lidal_tpu/ops/pallas_merge.py:211", "launches": launches["lookup_sorted"],
                "max_abs_err": lookup_err, "ms": lookup_ms, "plain_ms": lookup_plain_ms,
            },
            {
                "name": "subm_conv", "route": "cuda", "source": "lidal_tpu_torch/csrc/subm_conv.cu",
                "replaces": "lidal_tpu/ops/pallas_conv.py:387", "launches": launches["subm_conv"],
                "max_abs_err": conv_err, "ms": conv_ms, "plain_ms": conv_plain_ms,
            },
            {
                "name": "conv_dx_dw", "route": "cuda", "source": "lidal_tpu_torch/csrc/conv_dx_dw.cu",
                "replaces": "lidal_tpu/ops/pallas_conv.py:299", "launches": train_launches["conv_dx_dw"],
                "max_abs_err": dxdw_err, "ms": dxdw_ms, "plain_ms": dxdw_plain_ms,
            },
        ]
    }
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
