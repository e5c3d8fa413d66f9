"""SPVCNN: sparse point-voxel CNN (port of ``lidal_tpu/models/spvcnn.py``,
reference ``network/spvcnn.py:9-155``).

The MinkUNet trunk plus a point branch: trilinear devoxelize at strides 16 and
4, MLP point transforms with residual fusion, point->voxel re-injection with
dropout before up1 and up3, and a point-level classifier.  Returns ``(logits,
96-d point features)``.  Submodule names follow the reference (the trunk's,
and ``point_transforms.{0,1,2}.{0,1}``).

The "points" are the level-0 voxels (``ops/devoxelize.py``), so the stride-1
transfers are identities.  ``model.train()`` runs the differentiable convs and
the ``gather8`` / ``scatter8`` pair of the point transfers; ``model.eval()``
the fused conv + BN path.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from lidal_tpu_torch.models.layers import PerFrameDropout, PointTransform
from lidal_tpu_torch.models.minkunet import CS, MinkUNet
from lidal_tpu_torch.ops.devoxelize import (
    PointPlan,
    devoxelize_trilinear_batched,
    point_to_voxel_avg_batched,
)
from lidal_tpu_torch.ops.kernel_map import UNetPlan


class SPVCNN(MinkUNet):
    def __init__(self, num_classes: int, cs: Tuple[int, ...] = CS, in_channels: int = 4,
                 dropout_rate: float = 0.3):
        super().__init__(num_classes, cs, in_channels)
        self.point_transforms = nn.ModuleList(
            [PointTransform(cs[0], cs[4]), PointTransform(cs[4], cs[6]), PointTransform(cs[6], cs[8])]
        )
        self.dropout = PerFrameDropout(dropout_rate)

    def forward(self, feats: torch.Tensor, plan: UNetPlan, pplan: PointPlan,
                dropout_seeds: Optional[Sequence[int]] = None):
        """feats [B, cap0, in_channels] -> (logits [B, cap0, C], z3 [B, cap0, cs[8]]);
        logits are zero on invalid level-0 rows.  ``dropout_seeds``: one integer
        per frame for the train-mode dropout masks (:class:`PerFrameDropout`)."""
        dn = plan.downs
        valid0 = plan.levels[0].valid

        # z0 = voxel_to_point at stride 1 == identity, and so is point_to_voxel(x0, z0)
        x0 = self._stem(feats, plan)
        x1 = self._stage(1, x0, plan)
        x2 = self._stage(2, x1, plan)
        x3 = self._stage(3, x2, plan)
        x4 = self._stage(4, x3, plan)

        z1 = devoxelize_trilinear_batched(x4, pplan.tri4) + self.point_transforms[0](x0, valid0)

        y1 = self.dropout(point_to_voxel_avg_batched(z1, dn, pplan.avg4, levels=4), dropout_seeds, 1)
        y1 = self._up(1, y1, x3, plan)
        y2 = self._up(2, y1, x2, plan)

        z2 = devoxelize_trilinear_batched(y2, pplan.tri2) + self.point_transforms[1](z1, valid0)

        y3 = self.dropout(point_to_voxel_avg_batched(z2, dn, pplan.avg2, levels=2), dropout_seeds, 2)
        y3 = self._up(3, y3, x1, plan)
        y4 = self._up(4, y3, x0, plan)

        z3 = y4 + self.point_transforms[2](z2, valid0)
        logits = self.classifier(z3) * valid0[..., None]
        return logits, z3
