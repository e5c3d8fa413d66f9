"""The f32 sparse conv forward's share (%) of its roofline in the round's
eval forwards (the fused eval-BN epilogue): every call of
``lidal_tpu_torch.ops.cuda_conv.subm_conv`` over one round call,
operations 2 x real pairs x cin x cout, bytes the source rows the map
names, the weights, the map, the epilogue vectors and the output.  The
round queues device work from two threads on one stream, so a call's span
may hold the other thread's kernels: the share reads low, never high."""

from lidal_bench import work
from lidal_bench.metrics_common import share


def _work(a, k, out):
    feats, w, nbr = a[:3]
    scale = a[3] if len(a) > 3 else k.get("scale")
    shift = a[4] if len(a) > 4 else k.get("shift")
    return work.conv_fwd_work(feats, w, nbr, out, scale, shift)


INSTRUMENT = [("lidal_tpu_torch.ops.cuda_conv", "subm_conv", _work)]


def read(rec):
    return share(rec, "conv_fwd_roofline.round")
