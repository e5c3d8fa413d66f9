"""MinkUNet: sparse 3D U-Net (port of ``lidal_tpu/models/minkunet.py``,
reference ``network/minkunet.py:14-122``).

Channel plan cs = [32, 32, 64, 128, 256, 256, 128, 96, 96].  Encoder: stem (2x
conv3) + 4 stages of {down ks=2 s=2, 2 residual blocks}; decoder: 4 stages of
{transposed ks=2 s=2, skip-concat, 2 residual blocks}; linear classifier.
Returns ``(logits, 96-d penultimate features)``.  Submodule names follow the
reference (``stem.0``, ``stage1.1.net.0``, ``up1.0.net.0``, ``classifier.0``).
``model.train()`` runs the train-mode layers (differentiable convs, batch
statistics), ``model.eval()`` the fused inference path (``models/layers.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from lidal_tpu_torch.models.layers import (
    DownBlock,
    MaskedBatchNorm,
    ResidualBlock,
    SubMConv3,
    TorchLinear,
    UpBlock,
    conv_bn,
)
from lidal_tpu_torch.ops.kernel_map import UNetPlan

CS = (32, 32, 64, 128, 256, 256, 128, 96, 96)


class MinkUNet(nn.Module):
    def __init__(self, num_classes: int, cs: Tuple[int, ...] = CS, in_channels: int = 4):
        super().__init__()
        self.cs = cs
        self.stem = nn.Sequential(
            SubMConv3(in_channels, cs[0]), MaskedBatchNorm(cs[0]), nn.ReLU(True),
            SubMConv3(cs[0], cs[0]), MaskedBatchNorm(cs[0]), nn.ReLU(True),
        )
        enc = [(cs[0], cs[1]), (cs[1], cs[2]), (cs[2], cs[3]), (cs[3], cs[4])]
        for i, (cin, cout) in enumerate(enc):
            stage = nn.Sequential(DownBlock(cin, cin), ResidualBlock(cin, cout), ResidualBlock(cout, cout))
            self.add_module(f"stage{i + 1}", stage)
        dec = [(cs[4], cs[5], cs[3]), (cs[5], cs[6], cs[2]), (cs[6], cs[7], cs[1]), (cs[7], cs[8], cs[0])]
        for j, (cin, cout, cskip) in enumerate(dec):
            up = nn.ModuleList(
                [
                    UpBlock(cin, cout),
                    nn.Sequential(ResidualBlock(cout + cskip, cout), ResidualBlock(cout, cout)),
                ]
            )
            self.add_module(f"up{j + 1}", up)
        self.classifier = nn.Sequential(TorchLinear(cs[8], num_classes))

    def _stem(self, feats: torch.Tensor, plan: UNetPlan) -> torch.Tensor:
        lv0 = plan.levels[0]
        x = conv_bn(self.stem[0], self.stem[1], feats, lv0, lv0.valid, relu=True)
        return conv_bn(self.stem[3], self.stem[4], x, lv0, lv0.valid, relu=True)

    def _stage(self, i: int, x: torch.Tensor, plan: UNetPlan) -> torch.Tensor:
        """Encoder stage i (1-4): level i - 1 -> level i."""
        down, res1, res2 = getattr(self, f"stage{i}")
        level = plan.levels[i]
        return res2(res1(down(x, plan.downs[i - 1], level), level), level)

    def _up(self, j: int, y: torch.Tensor, skip: torch.Tensor, plan: UNetPlan) -> torch.Tensor:
        """Decoder stage j (1-4): level 5 - j -> level 4 - j, ``skip`` concatenated."""
        up, res = getattr(self, f"up{j}")
        level = plan.levels[4 - j]
        y = torch.cat([up(y, plan.downs[4 - j], level), skip], dim=-1)
        return res[1](res[0](y, level), level)

    def forward(self, feats: torch.Tensor, plan: UNetPlan):
        """feats [B, cap0, in_channels] -> (logits [B, cap0, C], feats [B, cap0, cs[8]]);
        logits are zero on invalid level-0 rows."""
        skips = [self._stem(feats, plan)]
        for i in range(1, 5):
            skips.append(self._stage(i, skips[-1], plan))
        y = skips[4]
        for j in range(1, 5):
            y = self._up(j, y, skips[4 - j], plan)
        logits = self.classifier(y) * plan.levels[0].valid[..., None]
        return logits, y
