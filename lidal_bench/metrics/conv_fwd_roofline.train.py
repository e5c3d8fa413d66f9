"""The f32 sparse conv forward's share (%) of its roofline in train steps:
every call of ``lidal_tpu_torch.ops.cuda_conv.subm_conv`` (``csrc/subm_conv.cu``
on ``gather_gemm.cuh``), operations 2 x real pairs x cin x cout, bytes the
source rows the map names, the weights, the map and the output."""

from lidal_bench import work
from lidal_bench.metrics_common import share


def _work(a, k, out):
    feats, w, nbr = a[:3]
    scale = a[3] if len(a) > 3 else k.get("scale")
    shift = a[4] if len(a) > 4 else k.get("shift")
    return work.conv_fwd_work(feats, w, nbr, out, scale, shift)


INSTRUMENT = [("lidal_tpu_torch.ops.cuda_conv", "subm_conv", _work)]


def read(rec):
    return share(rec, "conv_fwd_roofline.train")
