"""Confusion matrix + per-class IoU (port of ``lidal_tpu/utils/iou.py``).

Reference parity: ``utils/iou_sk.py`` / ``utils/iou_nu.py``: confusion over
points with gt < 100 (rows = pred, cols = gt), IoU = tp / (tp + fp + fn).
The numpy functions are copies: the JAX module imports ``jax.numpy``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

SK_CLASS_LABELS = (
    "car", "bicycle", "motorcycle", "truck", "other-vehicle", "person",
    "bicyclist", "motorcyclist", "road", "parking", "sidewalk", "other-ground",
    "building", "fence", "vegetation", "trunk", "terrain", "pole", "traffic-sign",
)
NU_CLASS_LABELS = (
    "barrier", "bicycle", "bus", "car", "construction_vehicle", "motorcycle",
    "pedestrian", "traffic_cone", "trailer", "truck", "driveable_surface",
    "other_flat", "sidewalk", "terrain", "manmade", "vegetation",
)


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[C, C] int64 on the inputs' device; rows = pred, cols = gt; ignores gt >= 100."""
    c = num_classes
    idx = torch.where(gt < 100, pred.long() * c + gt.long(), c * c)
    return torch.bincount(idx.reshape(-1), minlength=c * c + 1)[: c * c].reshape(c, c)


def per_class_iou(confusion: np.ndarray):
    """Returns (ious [C] float with NaN where absent, tps, denoms)."""
    tp = np.diag(confusion).astype(np.int64)
    fp = confusion.sum(1) - tp
    fn = confusion.sum(0) - tp
    denom = tp + fp + fn
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)
    return iou, tp, denom


def evaluate(confusion: np.ndarray, class_labels: Optional[Sequence[str]] = None) -> float:
    """Print the reference-format table; return mean IoU (absent classes count as 0)."""
    c = confusion.shape[0]
    labels = class_labels or (SK_CLASS_LABELS if c == 19 else NU_CLASS_LABELS)
    iou, tp, denom = per_class_iou(confusion)
    mean_iou = float(np.nan_to_num(iou, nan=0.0).mean())
    print("classes          IoU")
    print("----------------------------")
    for i in range(c):
        v = 0.0 if np.isnan(iou[i]) else float(iou[i])
        print(f"{labels[i]:<14s}: {v:>5.3f}   ({int(tp[i]):>6d}/{int(denom[i]):<6d})")
    print("mean IOU", mean_iou)
    return mean_iou
