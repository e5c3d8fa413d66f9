#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's MinkUNet eval path once on an NVIDIA GPU.

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

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np

SEED = 0
DEVICE = "cuda"
B = 4
N_PTS = 120_000
TIMED_BATCHES = 3
CONV_TOL = 1e-4
LOGIT_TOL = 1e-3
ARGMAX_AGREE = 0.999


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


def make_batch(rng, point_cap):
    """One loader-style batch dict of B frames, labels in 0..18."""
    xyz = np.zeros((B, point_cap, 3), np.float32)
    sig = np.zeros((B, point_cap), np.float32)
    valid = np.zeros((B, point_cap), bool)
    labels = np.full((B, point_cap), 255, np.int32)
    for i in range(B):
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


def main() -> None:
    import torch

    # ---- 1. device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py drives the port on an NVIDIA GPU")
    from lidal_tpu.config import SK_CONFIG, RunConfig
    from lidal_tpu_torch import kernels_build
    from lidal_tpu_torch.data.pipeline import prepare_eval_batch
    from lidal_tpu_torch.models.minkunet import MinkUNet
    from lidal_tpu_torch.ops import cuda_conv, cuda_merge
    from lidal_tpu_torch.ops.hashing import SENTINEL_KEY
    from lidal_tpu_torch.ops.kernel_map import rulebook_streams
    from lidal_tpu_torch.runtime.evaluate import run_eval

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
    for name in ("merge_lookup", "subm_conv"):
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
        ]
    }
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
