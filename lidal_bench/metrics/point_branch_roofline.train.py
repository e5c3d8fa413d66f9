"""SPVCNN's point transfers' share (%) of their roofline in train steps:
``gather8`` (trilinear devoxelize, 2 x pairs x c), ``child_sum`` (the point
averages: one add per real child per column, one divide per output value)
and ``scatter8`` (the gather's gradient, 2 x pairs x c), all of
``csrc/gather8.cu``, through ``lidal_tpu_torch.ops.cuda_gather8``."""

from lidal_bench import work
from lidal_bench.metrics_common import share


def _gather8(a, k, out):
    feats, nbr, w8 = a[:3]
    return work.gather8_work(feats, nbr, w8, out)


def _child_sum(a, k, out):
    x, children, counts = a[:3]
    return work.child_sum_work(x, children, counts, out)


def _scatter8(a, k, out):
    dy, nbr, w8, n = a[:4]
    return work.scatter8_work(dy, nbr, w8, n, out)


M = "lidal_tpu_torch.ops.cuda_gather8"
INSTRUMENT = [(M, "gather8_forward", _gather8), (M, "child_sum", _child_sum), (M, "scatter8", _scatter8)]


def read(rec):
    return share(rec, "point_branch_roofline.train")
