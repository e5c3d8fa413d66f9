"""Sparse network building blocks, eval mode (port of ``lidal_tpu/models/layers.py``).

Submodules carry the reference torchsparse names (``network/utils.py:105-172``:
``net.0`` conv, ``net.1`` BN, ``downsample.0/1``), so one name map serves a
torchsparse checkpoint and the JAX variables (``runtime/weights.py``).  Conv
kernels keep the JAX layout ``[K, cin, cout]`` with x-major taps.

In eval mode every conv + BN (+ ReLU) pair runs as one kernel launch: BN folds
into a per-channel ``(scale, shift)`` applied in the conv's epilogue.  Training
mode (batch statistics) is not ported yet and raises.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lidal_tpu_torch.ops.conv import down_conv_bn_batched, subm_conv_bn_batched, up_conv_bn_batched
from lidal_tpu_torch.ops.kernel_map import K2, K3, DownPlan, LevelPlan


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: only eval mode is ported; call model.eval()"
        )


class _SparseConv(nn.Module):
    """A conv weight ``kernel [K, cin, cout]`` with the torch kaiming_uniform(a=sqrt(5))
    fan-in bound 1/sqrt(K * cin), as the JAX ``conv_kernel_init``."""

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

    def forward(self, x: torch.Tensor, level: LevelPlan, epilogue) -> torch.Tensor:
        a, b, relu = epilogue
        return subm_conv_bn_batched(x, self.kernel, level.nbr3, a, b, relu)


class Conv1x1(_SparseConv):
    """Kernel-1 conv == per-voxel linear, no bias (spnn.Conv3d ks=1); a plain matmul."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel[0]


class DownConv2(_SparseConv):
    """Kernel-2 stride-2 conv (spnn.Conv3d ks=2 s=2)."""

    taps = K2

    def forward(self, x: torch.Tensor, down: DownPlan, epilogue) -> torch.Tensor:
        a, b, relu = epilogue
        return down_conv_bn_batched(x, self.kernel, down.child, a, b, relu)


class UpConv2(_SparseConv):
    """Kernel-2 stride-2 transposed conv (spnn.Conv3d ks=2 s=2 transposed=True)."""

    taps = K2

    def forward(self, x: torch.Tensor, down: DownPlan, epilogue) -> torch.Tensor:
        a, b, relu = epilogue
        return up_conv_bn_batched(x, self.kernel, down.parent, down.pdelta, a, b, relu)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over valid voxels, eval mode: running statistics only.

    Parameters and buffers use torch BatchNorm1d's names (``weight``, ``bias``,
    ``running_mean``, ``running_var``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def fused_affine(self):
        """The folded per-channel ``(scale, shift)`` for a conv epilogue."""
        _eval_only(self)
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return a, self.bias - self.running_mean * a

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps) * self.weight + self.bias
        return y * valid[..., None]


def conv_bn(conv: nn.Module, bn: MaskedBatchNorm, x: torch.Tensor, graph, relu: bool) -> torch.Tensor:
    """conv -> BN (-> ReLU) as one fused kernel launch."""
    a, b = bn.fused_affine()
    return conv(x, graph, epilogue=(a, b, relu))


class ConvBlock(nn.Module):
    """conv -> BN -> ReLU (reference BasicConvolutionBlock / BasicDeconvolutionBlock,
    ``net = Sequential(conv, bn, relu)``) over any of the three sparse convs."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.net = nn.Sequential(conv, MaskedBatchNorm(conv.cout), nn.ReLU(True))

    def forward(self, x: torch.Tensor, graph) -> torch.Tensor:
        return conv_bn(self.net[0], self.net[1], x, graph, relu=True)


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

    Both conv + BN pairs are fused (the first with its ReLU); the 1x1 shortcut
    is a plain matmul followed by the masked BN."""

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
        y = conv_bn(self.net[0], self.net[1], x, level, relu=True)
        y = conv_bn(self.net[3], self.net[4], y, level, relu=False)
        if self.downsample is None:
            sc = x
        else:
            sc = self.downsample[1](self.downsample[0](x), level.valid)
        return torch.relu(y + sc)


# nn.Linear's default init is the uniform(-1/sqrt(fan_in)) bound the JAX
# TorchLinear reproduces for both weight and bias; its layout is [out, in].
TorchLinear = nn.Linear
