"""Validation loop: voxel->point projection, confusion matrix, mIoU
(port of ``lidal_tpu/runtime/evaluate.py``, single device).

Reference parity: ``evaluate.py:18-128``: forward, project logits through the
voxelization inverse, confusion over gt < 100, IoU table.  The confusion
matrix and the overflow counts accumulate on the device and are read once,
after the last batch.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Union

import numpy as np
import torch

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.data.pipeline import IGNORE_LABEL, prepare_eval_batch
from lidal_tpu_torch.ops.voxelize import append_zero_row, devoxelize_nearest
from lidal_tpu_torch.utils.iou import confusion_matrix, evaluate as print_iou, per_class_iou


def project_logits_to_points(logits_v: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """[B, cap0, C] voxel logits -> [B, P, C] point logits via the dedup inverse
    (reference evaluate.py:104-107); sentinel rows gather zeros."""
    return devoxelize_nearest(append_zero_row(logits_v), inverse)


def batch_confusion(logits_v, inverse, point_valid, labels_p, num_classes: int) -> torch.Tensor:
    """[C, C] confusion of one batch; points that are invalid or ignored drop out."""
    pred = project_logits_to_points(logits_v, inverse).argmax(dim=-1)
    gt = torch.where(point_valid, labels_p.long(), IGNORE_LABEL)
    return confusion_matrix(pred.reshape(-1), gt.reshape(-1), num_classes)


class EvalResult(NamedTuple):
    miou: float  # mean IoU, absent classes counted as 0
    confusion: np.ndarray  # [C, C] int64, rows = pred, cols = gt
    overflow: np.ndarray  # [levels] voxels dropped per level, summed over batches
    points: int  # valid input points evaluated


def run_eval(
    cfg: RunConfig,
    model: torch.nn.Module,
    loader: Iterable[dict],
    device: Union[torch.device, str] = "cuda",
    generator: Optional[torch.Generator] = None,
    verbose: bool = False,
) -> EvalResult:
    """Evaluate ``model`` on ``device`` over batch dicts (``xyz`` [B, P, 3],
    ``sig``, ``valid``, ``labels`` [B, P], optional ``trunc_points``) as
    ``data/loader.py`` yields them.

    Frames are augmented with draws from ``generator`` (by default a CPU
    generator seeded from ``cfg.seed``), as the reference does in val mode.  Capacity overflow (voxels past a level cap, points truncated
    by the loader) is reported after the loop: reading it per batch would wait
    for the device every batch."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device="cpu").manual_seed(cfg.seed)
    data = cfg.data
    c = data.num_classes
    model.eval()
    conf = torch.zeros((c, c), dtype=torch.int64, device=device)
    ovfs = []
    points = torch.zeros((), dtype=torch.int64, device=device)
    with torch.inference_mode():
        for bi, batch in enumerate(loader):
            valid = torch.as_tensor(batch["valid"], device=device)
            eb = prepare_eval_batch(
                generator,
                torch.as_tensor(batch["xyz"], device=device),
                torch.as_tensor(batch["sig"], device=device),
                valid,
                level_caps=data.level_caps,
                scale=data.scale,
                full_scale=data.full_scale,
            )
            logits, _ = model(eb.feats, eb.plan)
            labels = torch.as_tensor(batch["labels"], device=device)
            conf += batch_confusion(logits, eb.inverse, eb.point_valid, labels, c)
            points += valid.sum()
            ovfs.append((bi, eb.overflow.sum(dim=0), batch.get("trunc_points", 0)))
    conf_np = conf.cpu().numpy()
    overflow = np.zeros(len(data.level_caps), np.int64)
    for bi, ovf, trunc in ovfs:
        ovf = ovf.cpu().numpy()
        overflow += ovf
        if ovf.any() or trunc:
            print(f"WARNING: capacity overflow (voxels {int(ovf.sum())}, points {trunc}) in eval batch {bi}")
    if verbose:
        miou = print_iou(conf_np)
    else:
        iou, _, _ = per_class_iou(conf_np)
        miou = float(np.nan_to_num(iou, nan=0.0).mean())
    return EvalResult(miou=miou, confusion=conf_np, overflow=overflow, points=int(points))
