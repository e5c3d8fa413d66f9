"""Batch preparation: augment -> voxelize -> plan
(port of ``lidal_tpu/data/pipeline.py``).

Frames keep a fixed per-frame capacity and the batch is a leading axis, as in
the JAX package, so every field compares with it directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lidal_tpu_torch.data.augment import AugmentDraws, augment_and_voxelize
from lidal_tpu_torch.ops.devoxelize import PointPlan, build_point_plan
from lidal_tpu_torch.ops.kernel_map import UNetPlan, build_unet_plan

IGNORE_LABEL = 255


def plan_overflow(plan: UNetPlan, uv_num_unique, uv_valid) -> torch.Tensor:
    """[B, levels] dropped-voxel counts; level 0 from the point voxelization.

    Static capacities drop voxels past the cap; callers report nonzero counts."""
    lvl0 = (uv_num_unique - uv_valid.sum(dim=1)).to(torch.int32)
    rest = [lv.overflow for lv in plan.levels[1:]]
    return torch.stack([lvl0] + rest, dim=1)


class TrainBatch(NamedTuple):
    feats: torch.Tensor  # [B, cap0, 4]
    labels: torch.Tensor  # [B, cap0] int32 (IGNORE_LABEL on invalid/ignored)
    plan: UNetPlan
    pplan: Optional[PointPlan]  # the SPVCNN transfer maps; None for MinkUNet
    overflow: torch.Tensor  # [B, levels] int32 unique voxels dropped per level


def prepare_train_batch(
    generator: Optional[torch.Generator],
    xyz: torch.Tensor,  # [B, P, 3]
    sig: torch.Tensor,  # [B, P]
    valid: torch.Tensor,  # [B, P]
    labels_p: torch.Tensor,  # [B, P] int32 (already remapped; IGNORE on pad)
    level_caps: Tuple[int, ...],
    scale: float = 20.0,
    full_scale: int = 8192,
    augment: bool = True,
    with_points: bool = False,
) -> TrainBatch:
    """A voxel's label is its first point's (np.unique keep-first,
    reference ``sk_dataset.py:167-171``); invalid voxels get IGNORE_LABEL.
    ``with_points`` adds the SPVCNN point plan."""
    vf = augment_and_voxelize(generator, xyz, sig, valid, level_caps[0], scale, full_scale, augment)
    plan = build_unet_plan(vf.uv.coords, vf.uv.valid, level_caps)
    labels_v = labels_p.gather(1, vf.uv.first_src.long())
    labels_v = torch.where(vf.uv.valid, labels_v, IGNORE_LABEL).to(torch.int32)
    return TrainBatch(
        feats=vf.feats,
        labels=labels_v,
        plan=plan,
        pplan=build_point_plan(plan) if with_points else None,
        overflow=plan_overflow(plan, vf.uv.num_unique, vf.uv.valid),
    )


class EvalBatch(NamedTuple):
    feats: torch.Tensor  # [B, cap0, 4]
    plan: UNetPlan
    pplan: Optional[PointPlan]  # the SPVCNN transfer maps; None for MinkUNet
    inverse: torch.Tensor  # [B, P] point -> voxel (sentinel cap0)
    point_valid: torch.Tensor  # [B, P]
    overflow: torch.Tensor  # [B, levels] int32 unique voxels dropped per level


def prepare_eval_batch(
    generator: Optional[torch.Generator],
    xyz: torch.Tensor,  # [B, P, 3]
    sig: torch.Tensor,  # [B, P]
    valid: torch.Tensor,  # [B, P]
    level_caps: Tuple[int, ...],
    scale: float = 20.0,
    full_scale: int = 8192,
    augment: bool = True,
    draws: Optional[AugmentDraws] = None,
    with_points: bool = False,
) -> EvalBatch:
    """Eval batches keep the point->voxel inverse for projecting voxel logits
    back to points (reference ``evaluate.py:104-107``).  The reference augments
    in val mode too (``sk_dataset.py:143-161``); ``augment=False`` gives the
    deterministic frame used by parity tests; ``draws`` gives the augmentation
    parameters instead of drawing them from ``generator``; ``with_points`` adds
    the SPVCNN point plan."""
    vf = augment_and_voxelize(generator, xyz, sig, valid, level_caps[0], scale, full_scale, augment, draws)
    plan = build_unet_plan(vf.uv.coords, vf.uv.valid, level_caps)
    return EvalBatch(
        feats=vf.feats,
        plan=plan,
        pplan=build_point_plan(plan) if with_points else None,
        inverse=vf.uv.inverse,
        point_valid=vf.point_valid,
        overflow=plan_overflow(plan, vf.uv.num_unique, vf.uv.valid),
    )


def forward_batch(model: torch.nn.Module, batch, dropout_seeds=None):
    """``(logits, feats)`` of ``model`` on a :class:`TrainBatch` or
    :class:`EvalBatch`: MinkUNet takes the features and the plan; a batch
    prepared ``with_points`` is SPVCNN's, which also takes the point plan and,
    in train mode, one dropout seed per frame."""
    if batch.pplan is None:
        return model(batch.feats, batch.plan)
    return model(batch.feats, batch.plan, batch.pplan, dropout_seeds)


def pad_points(xyz, sig, labels, point_cap: int):
    """Host-side: pad/trim one frame's raw arrays to the fixed point capacity.

    Returns numpy arrays (xyz [P,3] f32, sig [P] f32, valid [P] bool,
    labels [P] int32 with IGNORE on padding; labels may be None).
    """
    n = min(len(xyz), point_cap)
    oxyz = np.zeros((point_cap, 3), np.float32)
    osig = np.zeros((point_cap,), np.float32)
    ovalid = np.zeros((point_cap,), bool)
    olab = np.full((point_cap,), IGNORE_LABEL, np.int32)
    oxyz[:n] = xyz[:n]
    osig[:n] = sig[:n]
    ovalid[:n] = True
    if labels is not None:
        olab[:n] = labels[:n]
    return oxyz, osig, ovalid, olab
