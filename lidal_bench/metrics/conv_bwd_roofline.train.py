"""The f32 sparse conv backward's share (%) of its roofline: every call of
``lidal_tpu_torch.ops.cuda_conv_dxdw.conv_dx_dw`` (``csrc/conv_dx_dw.cu``: dx
on ``gather_gemm.cuh``, the per-tap pair lists and dW), operations 2 x real
pairs x c_src x (c_dst where dx is asked + c_f), bytes the rows read once and
the outputs."""

from lidal_bench import work
from lidal_bench.metrics_common import share


def _work(a, k, out):
    src, w2, nbr, f = a[:4]
    need_dx = a[4] if len(a) > 4 else k.get("need_dx", True)
    dx, dwg = out
    return work.conv_bwd_work(src, w2, nbr, f, need_dx, dx, dwg)


INSTRUMENT = [("lidal_tpu_torch.ops.cuda_conv_dxdw", "conv_dx_dw", _work)]


def read(rec):
    return share(rec, "conv_bwd_roofline.train")
