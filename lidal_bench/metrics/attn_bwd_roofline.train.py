"""PTv3's patch attention backward's share (%) of its roofline in train steps:
every call of ``lidal_tpu_torch.ops.patch_attention.patch_attention_backward``
(q, k, v, o, lse, dO -> dq, dk, dv; q ``[patches, heads, K, d]`` f32),
operations 8 x patches x K^2 x C, the four useful products (dP = dO v^T,
dv = P^T dO, dq = dS k, dk = dS^T q; the recomputed q k^T is not counted, so
the backward is twice the forward, as ``work/ptv3.py`` counts it) at the
split-TF32 ceiling (a third of the dense TF32 rate, as for
``attn_fwd_roofline.train``), bytes q, k, v, o, dO and lse read once and dq,
dk and dv written once at 3.35 TB/s; CUDA-event time of each call in steady
train steps after the window.  None where the program has no such function
(then nothing is wrapped and no call is timed)."""

import importlib

import torch

from lidal_bench.work import PEAK_TF32, Bound, nbytes

PEAK_SPLIT_TF32 = PEAK_TF32 / 3
MODULE = "lidal_tpu_torch.ops.patch_attention"


def _work(a, k, out):
    q, kk, v, o, lse, do = a[:6]
    p, h, n, d = q.shape
    return torch.tensor(8.0 * p * h * n * n * d), torch.tensor(float(nbytes(q, kk, v, o, lse, do, *out)))


def _present() -> bool:
    try:
        return hasattr(importlib.import_module(MODULE), "patch_attention_backward")
    except ImportError:
        return False


INSTRUMENT = [(MODULE, "patch_attention_backward", _work)] if _present() else []


def read(rec):
    calls = (rec.get("calls") or {}).get("attn_bwd_roofline.train") or []
    seconds = sum(s for _, _, s in calls)
    if not calls or seconds <= 0:
        return None
    bound = Bound(peak_ops=PEAK_SPLIT_TF32)
    for ops, moved, _ in calls:
        bound.add(moved, ops)
    return 100.0 * bound.total / seconds
