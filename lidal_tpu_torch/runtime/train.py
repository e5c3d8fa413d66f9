"""Training step: Adam + masked cross-entropy (port of ``lidal_tpu/runtime/train.py``,
single device).

The optimizer matches ``optim.Adam(model.parameters())`` defaults (lr=1e-3,
betas=(0.9, 0.999), eps=1e-8 — reference ``train.py:56``), as the JAX
package's optax Adam does.  The BN running statistics are updated by the
train-mode forward (``models/layers.MaskedBatchNorm``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from lidal_tpu_torch.data.pipeline import IGNORE_LABEL, TrainBatch, forward_batch


@dataclass
class TrainState:
    """What the JAX ``TrainState`` carries: the step count, the model (its
    parameters and BN statistics) and the optimizer (its Adam moments)."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def make_optimizer(model: torch.nn.Module, lr: float = 1e-3) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over labels != 255 (reference ``train.py:136``:
    F.cross_entropy(ignore_index=255, reduction='mean')), written as
    ``sum(nll * mask) / max(count, 1)`` so an all-ignored batch gives 0, as in
    the JAX package, and not the NaN of ``F.cross_entropy``."""
    mask = labels != IGNORE_LABEL
    safe = torch.where(mask, labels, 0).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1)


def train_step(state: TrainState, batch: TrainBatch, dropout_seeds=None) -> torch.Tensor:
    """One optimizer step on ``batch``: forward in train mode, loss, backward,
    Adam.  ``dropout_seeds`` (SPVCNN): one integer per frame for the dropout
    masks.  Returns the loss (detached, on the batch's device; reading it
    waits for the device)."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    logits, _ = forward_batch(model, batch, dropout_seeds)
    loss = cross_entropy_ignore(logits, batch.labels)
    loss.backward()
    opt.step()
    state.step += 1
    return loss.detach()
