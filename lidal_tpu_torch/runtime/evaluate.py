"""Validation loop: voxel->point projection, confusion matrix, mIoU
(port of ``lidal_tpu/runtime/evaluate.py``, one device or data parallel over a
process group).

Reference parity: ``evaluate.py:18-128``: forward, project logits through the
voxelization inverse, confusion over gt < 100, all-reduce, IoU table.  The
confusion matrix accumulates on the device and is read once, after the last
batch; the overflow counts are read every ``_OVF_DRAIN`` batches.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.data.augment import sample_augment
from lidal_tpu_torch.data.pipeline import IGNORE_LABEL, forward_batch, prepare_eval_batch
from lidal_tpu_torch.ops.voxelize import append_zero_row, devoxelize_nearest
from lidal_tpu_torch.parallel import mesh
from lidal_tpu_torch.utils.iou import confusion_matrix, evaluate as print_iou, per_class_iou

# Batches between overflow-warning drains in run_eval (the JAX package's
# window): large enough that the drained counts belong to long-finished
# batches (the read does not stall the device), small enough that a long
# eval is never blind to overflow for more than ~a minute of batches.
_OVF_DRAIN = 64


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
    group: Optional[dist.ProcessGroup] = None,
) -> EvalResult:
    """Evaluate ``model`` on ``device`` over batch dicts (``xyz`` [B, P, 3],
    ``sig``, ``valid``, ``labels`` [B, P], optional ``trunc_points``) as
    ``data/loader.py`` yields them.

    Frames are augmented with draws from ``generator`` (by default a CPU
    generator seeded from ``cfg.seed``), as the reference does in val mode.
    ``cfg.is_spvcnn`` says whether ``model`` takes the point plan.

    ``group``: ``loader`` yields global batches (over several ranks a
    ``FrameBatchLoader`` whose batch the group's size divides); each rank
    reads and evaluates its contiguous rows of each, augmented with its rows
    of the global batch's draws, and every rank returns the group's totals.

    Capacity overflow (voxels past a level cap, points truncated by the
    loader) is reported every ``_OVF_DRAIN`` batches and after the last, as
    the JAX package does: reading it per batch would wait for the device
    every batch.  Under a group the counts are the group's."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device="cpu").manual_seed(cfg.seed)
    data = cfg.data
    c = data.num_classes
    lo, n_ranks = 0, mesh.world(group)
    if n_ranks > 1:
        if loader.batch_size % n_ranks:
            raise ValueError(f"an eval batch of {loader.batch_size} frames does not split over {n_ranks} ranks")
        rows = mesh.process_shard(loader.batch_size, group)
        lo = rows.start
        loader = loader.with_rows(rows.start, rows.stop)
    lead = mesh.rank(group) == 0
    model.eval()
    conf = torch.zeros((c, c), dtype=torch.int64, device=device)
    points = torch.zeros((), dtype=torch.int64, device=device)
    overflow = np.zeros(len(data.level_caps), np.int64)
    ovfs = []  # (batch index, [levels + 1] voxels dropped per level and points truncated) not read yet

    def drain_ovfs() -> None:
        if not ovfs:
            return
        counts = mesh.all_reduce_(torch.stack([o for _, o in ovfs]), group)
        for (bi, _), row in zip(ovfs, counts.cpu().numpy()):
            overflow[:] += row[:-1]
            if row.any() and lead:
                print(f"WARNING: capacity overflow (voxels {int(row[:-1].sum())}, points {int(row[-1])}) "
                      f"in eval batch {bi}")
        ovfs.clear()

    with torch.inference_mode():
        for bi, batch in enumerate(loader):
            valid = torch.as_tensor(batch["valid"], device=device)
            b = valid.shape[0]
            draws = sample_augment(generator, b * n_ranks)  # the global batch's, of which this rank's rows
            eb = prepare_eval_batch(
                None,
                torch.as_tensor(batch["xyz"], device=device),
                torch.as_tensor(batch["sig"], device=device),
                valid,
                level_caps=data.level_caps,
                scale=data.scale,
                full_scale=data.full_scale,
                draws=draws.rows(lo, lo + b),
                with_points=cfg.is_spvcnn,
            )
            logits, _ = forward_batch(model, eb)
            labels = torch.as_tensor(batch["labels"], device=device)
            conf += batch_confusion(logits, eb.inverse, eb.point_valid, labels, c)
            points += valid.sum()
            trunc = torch.tensor([batch.get("trunc_points", 0)], dtype=torch.int64, device=device)
            ovfs.append((bi, torch.cat([eb.overflow.sum(dim=0), trunc])))
            if len(ovfs) >= _OVF_DRAIN:
                drain_ovfs()
        totals = mesh.all_reduce_(torch.cat([conf.reshape(-1), points.reshape(1)]), group)
        conf, points = totals[:-1].reshape(c, c), totals[-1]
        conf_np = conf.cpu().numpy()
        drain_ovfs()
    if verbose and lead:
        miou = print_iou(conf_np)
    else:
        iou, _, _ = per_class_iou(conf_np)
        miou = float(np.nan_to_num(iou, nan=0.0).mean())
    return EvalResult(miou=miou, confusion=conf_np, overflow=overflow, points=int(points))
