"""Process groups for data-parallel runs (port of ``lidal_tpu/parallel/mesh.py``).

The reference's only parallelism is single-host data parallelism over NCCL
(SURVEY.md section 2.3).  The JAX package expresses it as a 1-D ``data`` mesh
whose reductions XLA inserts as ``psum``; here it is a ``torch.distributed``
process group (NCCL for CUDA devices, gloo for the CPU) with one process per
card, and the reductions are explicit:

* training: each rank holds its contiguous rows of every global batch; the
  loss divides the rank's sum by the global valid count, BN statistics and
  gradients are summed over the group (:func:`all_reduce_sum`), so a step
  equals the single-device step up to the order of the sums;
* eval: the confusion matrix, the valid-point count and the overflow counts
  are summed over the group;
* inference and scoring: each rank takes its contiguous share of the frames
  (:func:`process_shard`).

The JAX package's ``make_mesh``, ``shard_batch_spec``, ``replicated_spec``,
``shard_batch`` and ``replicate`` have no counterpart: a rank loads only its
own rows of a batch, and the parameters are replicated by one broadcast from
rank 0 at the start of training (``runtime/train_loop.run_train``).

Every helper takes the group as ``group``; ``None`` means no group (one
process): rank 0 of 1, the whole range, no barrier, and a sum over one rank.
Nothing here creates a group at import: :func:`init_from_env` does, for the
command line under ``torchrun``, and :func:`init_group` for a launcher that
names the rank, the size and the address itself (the benchmark's
data-parallel loop); tests and scripts may create their own and pass it to
the entry points as ``group``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from lidal_tpu_torch.utils import profiling

# How long a rank may wait in a collective: sized to the longest stage that
# one rank runs while the others wait at a fence (a selection metric scored
# by rank 0 over a whole split, minutes to tens of minutes), not to torch's
# 10-minute NCCL default.  A rank that dies does not hold the others this
# long: torchrun ends the other workers when one exits with an error.
GROUP_TIMEOUT = datetime.timedelta(hours=4)


def init_from_env(device: Union[torch.device, str] = "cuda") -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), with
    :data:`GROUP_TIMEOUT`, and return this rank's device: ``cuda:LOCAL_RANK``
    over NCCL for a CUDA ``device``, the CPU over gloo otherwise.  Without
    ``WORLD_SIZE``, or with 1, it creates no group and returns ``device`` as
    given."""
    device = torch.device(device)
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return init_group(int(os.environ["RANK"]), world_size, "env://", device)


def init_group(rank_: int, world_size: int, init_method: str, device: Union[torch.device, str],
               timeout: datetime.timedelta = GROUP_TIMEOUT) -> torch.device:
    """Join the default process group as ``rank_`` of ``world_size`` at
    ``init_method`` (``env://``, ``tcp://host:port``, ``file://...``): over
    NCCL on a CUDA ``device``, made this process's current device and the
    group's ``device_id`` (``cuda`` alone means ``cuda:rank_``), over gloo on
    the CPU.  Returns the device."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank_)
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=init_method,
        rank=rank_,
        world_size=world_size,
        timeout=timeout,
        device_id=device if device.type == "cuda" else None,
    )
    return device


def rank(group: Optional[dist.ProcessGroup]) -> int:
    """This process's rank in ``group``; 0 without one."""
    return 0 if group is None else dist.get_rank(group)


def world(group: Optional[dist.ProcessGroup]) -> int:
    """The size of ``group``; 1 without one."""
    return 1 if group is None else dist.get_world_size(group)


def sync_hosts(name: str, group: Optional[dist.ProcessGroup]) -> None:
    """Barrier at a filesystem-write fence named ``name``: the reference's
    ``dist.barrier()`` around rank-0 artifact writes (``sk_dataloader.py:30-36,
    131-132``).  A no-op unless ``group`` has more than one rank."""
    if world(group) > 1:
        dist.barrier(group)


def process_shard(n_items: int, group: Optional[dist.ProcessGroup]) -> range:
    """This rank's contiguous share of ``range(n_items)``, the reference's
    score-loader split (``sk_dataloader.py:196-198``): ceil(n / ranks) items
    a rank, the last ranks' shares shorter or empty."""
    r, w = rank(group), world(group)
    per = -(-n_items // w)
    return range(min(r * per, n_items), min((r + 1) * per, n_items))


def all_reduce_(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no autograd) and return it; ``t``
    itself without a group.  Counted in ``utils.profiling``: calls
    (``all_reduce.calls``) and the bytes of ``t`` (``all_reduce.bytes``)."""
    if group is None:
        return t
    profiling.count("all_reduce.calls")
    profiling.count("all_reduce.bytes", t.numel() * t.element_size())
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum of ``t`` over the group.  Backward: the sum of the
    incoming gradient over the group, the transpose of ``psum`` under JAX's
    ``shard_map`` (every rank's loss depends on every rank's ``t``)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``group`` (a new tensor)."""
    return _AllReduceSum.apply(t, group)
