"""Determinism auditing (port of ``lidal_tpu/utils/determinism.py``).

The reference has no race detection or reproducibility tooling (SURVEY.md §5.2);
its safety is by construction (rank-0 writes + barriers).  The selection
rankings additionally require bitwise-deterministic compute (BASELINE north
star).  This module provides the audit: run a pipeline stage twice and compare
content hashes of every output leaf.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = ""):
    """(key path, leaf) pairs of a nested dict / list / tuple, keyed as
    ``jax.tree_util.keystr`` keys them (``['a'][0]``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _digest(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        raw, dtype, shape = t.reshape(-1).view(torch.uint8).numpy().tobytes(), str(t.dtype), str(tuple(t.shape))
    else:
        a = np.asarray(leaf)
        raw, dtype, shape = a.tobytes(), str(a.dtype), str(a.shape)
    return hashlib.sha256(raw + dtype.encode() + shape.encode()).hexdigest()


def tree_fingerprint(tree: Any) -> Dict[str, str]:
    """Stable content hash per leaf (path -> sha256 of raw bytes, dtype and
    shape); ``tree`` is a state dict or a nested tree of tensors / arrays."""
    return {path: _digest(leaf) for path, leaf in _leaves(tree)}


def check_deterministic(
    fn: Callable[[], Any], runs: int = 2
) -> Tuple[bool, Dict[str, Tuple[str, str]]]:
    """Run ``fn`` ``runs`` times; returns (ok, {leaf_path: (hash_a, hash_b)} for
    mismatching leaves)."""
    base = tree_fingerprint(fn())
    bad: Dict[str, Tuple[str, str]] = {}
    for _ in range(runs - 1):
        cur = tree_fingerprint(fn())
        for k, h in base.items():
            if cur.get(k) != h:
                bad[k] = (h, cur.get(k, "<missing>"))
    return (not bad), bad
