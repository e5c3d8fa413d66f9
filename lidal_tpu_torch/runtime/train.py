"""Training step: Adam + masked cross-entropy (port of ``lidal_tpu/runtime/train.py``).

The optimizer matches ``optim.Adam(model.parameters())`` defaults (lr=1e-3,
betas=(0.9, 0.999), eps=1e-8 — reference ``train.py:56``), as the JAX
package's optax Adam does.  The BN running statistics are updated by the
train-mode forward (``models/layers.MaskedBatchNorm``).

Data parallel (``group``): each rank's loss is its sum over the GLOBAL valid
count, and the loss and the gradients are summed over the group, as the JAX
package's ``psum`` under ``shard_map`` does, so the step equals the
single-device step up to the order of the sums.  ``DistributedDataParallel``
would average per-rank means instead, which differs when the ranks hold
unequal valid counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from lidal_tpu_torch.data.pipeline import IGNORE_LABEL, TrainBatch, forward_batch
from lidal_tpu_torch.parallel import mesh
from lidal_tpu_torch.utils import profiling

# Elements per flat buffer of a gradient all-reduce (64 MiB of f32).
BUCKET_NUMEL = 1 << 24


@dataclass
class TrainState:
    """What the JAX ``TrainState`` carries: the step count, the model (its
    parameters and BN statistics) and the optimizer (its Adam moments)."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def make_optimizer(model: torch.nn.Module, lr: float = 1e-3) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Mean CE over labels != 255 (reference ``train.py:136``:
    F.cross_entropy(ignore_index=255, reduction='mean')), written as
    ``sum(nll * mask) / max(count, 1)`` so an all-ignored batch gives 0, as in
    the JAX package, and not the NaN of ``F.cross_entropy``.  With ``group``
    the count is summed over the group: the rank's share of the global mean."""
    mask = labels != IGNORE_LABEL
    safe = torch.where(mask, labels, 0).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    cnt = mesh.all_reduce_(mask.sum(), group)
    return (nll * mask).sum() / cnt.clamp_min(1)


def flat_buckets(tensors: Iterable[torch.Tensor], numel: int = BUCKET_NUMEL) -> Iterator[List[torch.Tensor]]:
    """``tensors`` in consecutive groups of at most ``numel`` elements (a
    larger tensor alone), the units of one flat collective each."""
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        if bucket and size + t.numel() > numel:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


def sum_gradients(model: torch.nn.Module, group: Optional[dist.ProcessGroup]) -> None:
    """Sum the parameters' gradients over ``group``, one all-reduce per flat
    bucket.  A parameter without a gradient keeps none, so Adam skips it as
    in the single-device step; which parameters have one is fixed by the
    model's structure, the same on every rank."""
    if group is None:
        return
    for bucket in flat_buckets(p.grad for p in model.parameters() if p.grad is not None):
        flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in bucket]), group)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))


def train_step(state: TrainState, batch: TrainBatch, dropout_seeds=None,
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """One optimizer step on ``batch``: forward in train mode, loss, backward,
    Adam.  ``dropout_seeds`` (SPVCNN): one integer per frame for the dropout
    masks.  ``group``: ``batch`` is this rank's rows of a global batch; the
    loss and the gradients are summed over the group before Adam (the model's
    BNs must sum over the same group: ``runtime/train_loop.build_model``).
    Returns the loss (detached, on the batch's device; reading it waits for
    the device).  Spans (``utils.profiling``): ``train.step`` around
    ``train.forward``, ``train.loss``, ``train.backward``,
    ``train.all_reduce`` (with a group) and ``train.optimizer``."""
    model, opt = state.model, state.optimizer
    with profiling.span("train.step"):
        model.train()
        opt.zero_grad(set_to_none=True)
        with profiling.span("train.forward"):
            logits, _ = forward_batch(model, batch, dropout_seeds)
        with profiling.span("train.loss"):
            loss = cross_entropy_ignore(logits, batch.labels, group)
        with profiling.span("train.backward"):
            loss.backward()
        loss = loss.detach()
        if group is not None:
            with profiling.span("train.all_reduce"):
                loss = mesh.all_reduce_(loss, group)
                sum_gradients(model, group)
        with profiling.span("train.optimizer"):
            opt.step()
        state.step += 1
    return loss
