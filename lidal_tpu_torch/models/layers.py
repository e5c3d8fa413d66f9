"""Sparse network building blocks (port of ``lidal_tpu/models/layers.py``).

Submodules carry the reference torchsparse names (``network/utils.py:105-172``:
``net.0`` conv, ``net.1`` BN, ``downsample.0/1``), so one name map serves a
torchsparse checkpoint and the JAX variables (``runtime/weights.py``).  Conv
kernels keep the JAX layout ``[K, cin, cout]`` with x-major taps.

The module's mode picks the path, as ``train`` does in the JAX package:

* eval: every conv + BN (+ ReLU) pair runs as one kernel launch; BN folds
  into a per-channel ``(scale, shift)`` applied in the conv's epilogue;
* train: conv (differentiable, ``ops/conv.py``) -> BN with masked batch
  statistics -> ReLU, unfused, since BN needs the conv's whole output first.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lidal_tpu_torch.ops.conv import (
    down_conv_batched,
    down_conv_bn_batched,
    subm_conv_batched,
    subm_conv_bn_batched,
    up_conv_batched,
    up_conv_bn_batched,
)
from lidal_tpu_torch.ops.kernel_map import K2, K3, DownPlan, LevelPlan
from lidal_tpu_torch.parallel.mesh import all_reduce_sum


class _SparseConv(nn.Module):
    """A conv weight ``kernel [K, cin, cout]`` with the torch kaiming_uniform(a=sqrt(5))
    fan-in bound 1/sqrt(K * cin), as the JAX ``conv_kernel_init``.

    ``epilogue = (scale, shift, relu)`` fuses the eval-BN affine (+ ReLU +
    validity mask) into the conv kernel's output store; without it the conv
    is the differentiable one."""

    taps = 1

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.kernel = nn.Parameter(torch.empty(self.taps, cin, cout))
        bound = 1.0 / math.sqrt(self.taps * cin)
        nn.init.uniform_(self.kernel, -bound, bound)


class SubMConv3(_SparseConv):
    """Kernel-3 stride-1 submanifold conv (spnn.Conv3d ks=3 s=1)."""

    taps = K3

    def forward(self, x: torch.Tensor, level: LevelPlan, epilogue=None) -> torch.Tensor:
        if epilogue is None:
            return subm_conv_batched(x, self.kernel, level.nbr3)
        a, b, relu = epilogue
        return subm_conv_bn_batched(x, self.kernel, level.nbr3, a, b, relu)


class Conv1x1(_SparseConv):
    """Kernel-1 conv == per-voxel linear, no bias (spnn.Conv3d ks=1); a plain matmul."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel[0]


class DownConv2(_SparseConv):
    """Kernel-2 stride-2 conv (spnn.Conv3d ks=2 s=2)."""

    taps = K2

    def forward(self, x: torch.Tensor, down: DownPlan, epilogue=None) -> torch.Tensor:
        if epilogue is None:
            return down_conv_batched(x, self.kernel, down.child, down.parent, down.pdelta)
        a, b, relu = epilogue
        return down_conv_bn_batched(x, self.kernel, down.child, a, b, relu)


class UpConv2(_SparseConv):
    """Kernel-2 stride-2 transposed conv (spnn.Conv3d ks=2 s=2 transposed=True)."""

    taps = K2

    def forward(self, x: torch.Tensor, down: DownPlan, epilogue=None) -> torch.Tensor:
        if epilogue is None:
            return up_conv_batched(x, self.kernel, down.child, down.parent, down.pdelta)
        a, b, relu = epilogue
        return up_conv_bn_batched(x, self.kernel, down.parent, down.pdelta, a, b, relu)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid voxels of the whole batch.

    Train mode matches torch semantics (``layers.py:139-161`` of the JAX
    package): biased variance for normalization, unbiased for the running
    estimate, ``running = (1 - momentum) * running + momentum * batch``; an
    all-invalid batch counts as one voxel.  Eval mode uses the running
    statistics.  Parameters and buffers use torch BatchNorm1d's names
    (``weight``, ``bias``, ``running_mean``, ``running_var``).

    ``group`` (a ``torch.distributed`` process group, set by
    :func:`sync_batchnorm`; data parallel): the batch is the union of every
    rank's rows.  Train mode sums over the group first the count and the
    channel sums (one tensor), then the centred squares, as the JAX
    package's ``bn_axis`` psums do, so every rank normalises with, and keeps,
    the global statistics.  ``nn.SyncBatchNorm`` has no mask."""

    momentum = 0.1

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def fused_affine(self):
        """The folded per-channel eval ``(scale, shift)`` for a conv epilogue."""
        if self.training:
            raise RuntimeError("the fused BN affine is an eval-mode path")
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return a, self.bias - self.running_mean * a

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps) * self.weight + self.bias
            return y * valid[..., None]
        m = valid.to(x.dtype)[..., None]
        dims = tuple(range(x.dim() - 1))
        if self.group is None:
            cnt = m.sum().clamp_min(1.0)
            mean = (x * m).sum(dims) / cnt
            var = ((x - mean).square() * m).sum(dims) / cnt
        else:
            sums = all_reduce_sum(torch.cat([m.sum().reshape(1), (x * m).sum(dims)]), self.group)
            cnt = sums[0].clamp_min(1.0)
            mean = sums[1:] / cnt
            var = all_reduce_sum(((x - mean).square() * m).sum(dims), self.group) / cnt
        with torch.no_grad():
            unbiased = var * cnt / (cnt - 1.0).clamp_min(1.0)
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased)
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y * valid[..., None]


def sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Sum every :class:`MaskedBatchNorm` of ``model`` over ``group`` in
    train mode (``None``: each over its own rows); returns ``model``."""
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            m.group = group
    return model


def conv_bn(conv: nn.Module, bn: MaskedBatchNorm, x: torch.Tensor, graph, valid: torch.Tensor,
            relu: bool) -> torch.Tensor:
    """conv -> BN (-> ReLU): one fused kernel launch in eval mode; in train
    mode the differentiable conv, then BN over ``valid`` (the output level's
    mask), then ReLU."""
    if not bn.training:
        a, b = bn.fused_affine()
        return conv(x, graph, epilogue=(a, b, relu))
    y = bn(conv(x, graph), valid)
    return torch.relu(y) if relu else y


class ConvBlock(nn.Module):
    """conv -> BN -> ReLU (reference BasicConvolutionBlock / BasicDeconvolutionBlock,
    ``net = Sequential(conv, bn, relu)``) over any of the three sparse convs."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.net = nn.Sequential(conv, MaskedBatchNorm(conv.cout), nn.ReLU(True))

    def forward(self, x: torch.Tensor, graph, out_level: LevelPlan) -> torch.Tensor:
        return conv_bn(self.net[0], self.net[1], x, graph, out_level.valid, relu=True)


class DownBlock(ConvBlock):
    """conv ks=2 s=2 -> BN -> ReLU over a :class:`DownPlan`."""

    def __init__(self, cin: int, cout: int):
        super().__init__(DownConv2(cin, cout))


class UpBlock(ConvBlock):
    """transposed conv ks=2 s=2 -> BN -> ReLU over a :class:`DownPlan`."""

    def __init__(self, cin: int, cout: int):
        super().__init__(UpConv2(cin, cout))


class ResidualBlock(nn.Module):
    """conv-BN-ReLU-conv-BN + (identity | 1x1 conv-BN) -> ReLU
    (reference ResidualBlock, ``network/utils.py:142-172``; stride 1).

    In eval mode both conv + BN pairs are fused (the first with its ReLU);
    the 1x1 shortcut is a plain matmul followed by the masked BN."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.net = nn.Sequential(
            SubMConv3(cin, cout), MaskedBatchNorm(cout), nn.ReLU(True),
            SubMConv3(cout, cout), MaskedBatchNorm(cout),
        )
        self.downsample = (
            nn.Sequential(Conv1x1(cin, cout), MaskedBatchNorm(cout)) if cin != cout else None
        )

    def forward(self, x: torch.Tensor, level: LevelPlan) -> torch.Tensor:
        y = conv_bn(self.net[0], self.net[1], x, level, level.valid, relu=True)
        y = conv_bn(self.net[3], self.net[4], y, level, level.valid, relu=False)
        if self.downsample is None:
            sc = x
        else:
            sc = self.downsample[1](self.downsample[0](x), level.valid)
        return torch.relu(y + sc)


# nn.Linear's default init is the uniform(-1/sqrt(fan_in)) bound the JAX
# TorchLinear reproduces for both weight and bias; its layout is [out, in].
TorchLinear = nn.Linear


class PointTransform(nn.Sequential):
    """Linear -> BatchNorm1d over the valid points -> ReLU on point features
    (reference ``network/spvcnn.py:85-101``; submodules ``0`` and ``1`` as
    there).  The Linear is a plain matrix product, as in the JAX package."""

    def __init__(self, cin: int, cout: int):
        super().__init__(TorchLinear(cin, cout), MaskedBatchNorm(cout), nn.ReLU(True))

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return torch.relu(self[1](self[0](x), valid))


class PerFrameDropout(nn.Module):
    """Dropout whose mask is drawn per FRAME from that frame's own seed.

    ``seeds`` holds one integer per frame of ``x [B, ...]``.  Frame b's mask
    comes from a generator on ``x``'s device seeded from ``(seeds[b], site)``,
    so it depends neither on the frame's batch mates nor on its place in the
    batch (the property the JAX package gets from per-frame keys; the bits
    themselves differ between the two frameworks).  ``site`` tells the
    model's dropout sites apart.  Without seeds it is ``F.dropout`` over the
    whole batch from torch's global generator.  Identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, seeds: Optional[Sequence[int]], site: int) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if seeds is None:
            return F.dropout(x, self.rate, training=True)
        if len(seeds) != x.shape[0]:
            raise ValueError(f"{len(seeds)} dropout seeds for {x.shape[0]} frames")
        keep = 1.0 - self.rate
        masks = []
        for seed in seeds:
            mixed = np.random.SeedSequence([int(seed), site]).generate_state(1, np.uint64)[0]
            g = torch.Generator(device=x.device).manual_seed(int(mixed) & (2**63 - 1))
            masks.append(torch.rand(x.shape[1:], generator=g, device=x.device) < keep)
        return torch.where(torch.stack(masks), x / keep, 0.0)
