"""Lookups of sorted query streams in sorted key tables
(port of ``lidal_tpu/ops/merge_lookup.py:237-263``).

The JAX package merges each stream with its table (a bitonic network, or the
Pallas ``merge_rank_pallas`` on a TPU).  Here every query is a binary search
in the kernel of ``ops/cuda_merge.py``, so the results need no promise that
query keys are unique: ``lookup_sorted_grouped`` equals the JAX function in
both of its ``unique_queries`` modes wherever that promise holds.
"""

from __future__ import annotations

import torch

from lidal_tpu_torch.ops import cuda_merge


def lookup_sorted_grouped(t_hi, t_lo, q_hi, q_lo) -> torch.Tensor:
    """Per-stream table rows of sorted queries (``n`` where absent or sentinel).

    Args:
      t_hi/t_lo: int32 [T, n] sorted tables (sentinel tails).
      q_hi/q_lo: int32 [S, m] sorted query streams, S a multiple of T; the
        S // T consecutive streams of group ``s`` search table ``s``.

    Returns: int32 [S, m].
    """
    return cuda_merge.lookup_sorted(t_hi, t_lo, q_hi, q_lo, with_found=True)


def lower_bound_sorted_grouped(t_hi, t_lo, q_hi, q_lo) -> torch.Tensor:
    """Per-stream lower bounds [S, m] (insertion points; duplicates allowed)."""
    return cuda_merge.lookup_sorted(t_hi, t_lo, q_hi, q_lo, with_found=False)
