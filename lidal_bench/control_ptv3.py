"""Readings that set ``sk_ptv3_train``'s limits (not run by the benchmark's runs).

    python3 -m lidal_bench.control_ptv3 --seeds 1,2,3 [--faults tf32,bf16_qkv,zero_pad,no_shuffle] [--seconds 1]

For each seed, on the card, a run of the cell with a short window: the
program as it is (the lower readings) and, for each fault asked, the program
with that fault planted in it while its steps run (each must read ``correct``
false):

* ``tf32``: TF32 on for the step's matmuls (on the CPU: the Linears' operands
  rounded to TF32's 10-bit mantissa, which is what the card's TF32 does);
* ``bf16_qkv``: q, k and v rounded to bf16 before the attention;
* ``zero_pad``: the last patch of each frame padded with zero tokens;
* ``no_shuffle``: the four orders as written at every level.

One JSON line per seed and kind.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch
import torch.nn.functional as F

from lidal_bench import run

FAULTS = ("tf32", "bf16_qkv", "zero_pad", "no_shuffle")


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 to TF32's 10 mantissa bits, to nearest (ties away from zero)."""
    bits = x.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _LinearTF32(torch.autograd.Function):
    """``F.linear`` with every product's operands rounded to TF32, forward and backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        y = _round_tf32(x) @ _round_tf32(w).t()
        return y if b is None else y + b

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = _round_tf32(gy)
        gx = g @ _round_tf32(w)
        gw = g.reshape(-1, g.shape[-1]).t() @ _round_tf32(x).reshape(-1, x.shape[-1])
        gb = gy.reshape(-1, gy.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb


@contextlib.contextmanager
def _tf32(device_type: str):
    if device_type == "cuda":
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
        return
    orig = F.linear

    def linear(x, w, b=None):
        return _LinearTF32.apply(x, w, b)

    F.linear = linear
    try:
        yield
    finally:
        F.linear = orig


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` in it (restored on exit)."""
    from lidal_tpu_torch.ops import patch_attention, serialize
    from lidal_tpu_torch.runtime import train_loop

    saved = []

    def swap(mod, attr, new):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    if fault == "tf32":
        orig_step = train_loop.train_step

        def train_step(state, batch, *a, **k):
            with _tf32(batch.feats.device.type):
                return orig_step(state, batch, *a, **k)
        swap(train_loop, "train_step", train_step)
    elif fault == "bf16_qkv":
        orig_attn = patch_attention.patch_attention

        def attn(q, k, v):
            return orig_attn(*(t.to(torch.bfloat16).float() for t in (q, k, v)))
        swap(patch_attention, "patch_attention", attn)
    elif fault == "zero_pad":
        swap(patch_attention, "pad_sources", lambda j, n, k: torch.where(j < n, j, -1))
    elif fault == "no_shuffle":
        swap(serialize, "order_perms", lambda seed, levels: [list(range(len(serialize.ORDERS)))] * levels)
    else:
        raise ValueError(f"no fault {fault!r}")
    try:
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--no-program", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = run.load_bench()
    info = run.card()
    kinds = ([] if args.no_program else ["program"]) + [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind in kinds:
            with planted(kind) if kind != "program" else contextlib.nullcontext():
                out = run.run_cell(bench, "sk_ptv3_train", seed, args.seconds, False, "cuda", info)
            print(json.dumps({"seed": seed, "kind": kind, "correct": out["correct"], "card": info.get("nvidia_smi"),
                              "readings": {r["name"]: r["value"] for r in out["checks"]},
                              "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                              "setup_s": out["metrics"]["setup_s"]["value"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
