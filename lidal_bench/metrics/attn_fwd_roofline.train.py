"""PTv3's patch attention forward's share (%) of its roofline in train steps:
every call of ``lidal_tpu_torch.ops.patch_attention.patch_attention`` (q, k,
v ``[patches, heads, K, d]`` f32), operations 4 x patches x K^2 x C at the
H100's split-TF32 peak, bytes q, k, v and the output once at 3.35 TB/s;
CUDA-event time of each call in steady train steps after the window.  The
f32 attention kernels (cutlass ``OpMultiplyAddFastF32``) make each f32
product of three TF32 tensor-core products, so their ceiling is a third of
the dense TF32 rate (165 TFLOP/s), as for the split-TF32 conv kernels; the
f32 FMA rate (67 TFLOP/s) would bound a kernel that can run faster than it.
None where the program has no such function (no call is timed)."""

from lidal_bench.work import PEAK_TF32, Bound
from lidal_bench.work.ptv3 import attention_work

PEAK_SPLIT_TF32 = PEAK_TF32 / 3


def _work(a, k, out):
    q, kk, v = a[:3]
    return attention_work(q, kk, v, out)


INSTRUMENT = [("lidal_tpu_torch.ops.patch_attention", "patch_attention", _work)]


def read(rec):
    calls = (rec.get("calls") or {}).get("attn_fwd_roofline.train") or []
    seconds = sum(s for _, _, s in calls)
    if not calls or seconds <= 0:
        return None
    bound = Bound(peak_ops=PEAK_SPLIT_TF32)
    for ops, moved, _ in calls:
        bound.add(moved, ops)
    return 100.0 * bound.total / seconds
