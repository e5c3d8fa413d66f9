"""Whole-round and whole-experiment orchestration (port of
``lidal_tpu/runtime/round.py``).

The reference drives active-learning rounds manually: per round the user invokes
train, then prob_inference, then the metric's scoring script, then retrains
(reference ``README.md`` usage section).  This module chains those stages behind
one call with the same artifact contract, so a full LiDAL experiment is:

    run_experiment(cfg, rounds=5)

Stage order per round r (>= 1):
  1. train on round-(r-1) labels (round 0: bootstrap 1%);
  2. evaluate val mIoU (optional);
  3. multi-view prob inference with the round-r-1 model;
  4. score + select round-r labels with the configured metric;
and the next round's train consumes the new flags.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from lidal_tpu_torch.config import RunConfig


def train_cfg_for_round(cfg: RunConfig, r_id: int) -> RunConfig:
    return dataclasses.replace(cfg, r_id=r_id)


def inference_cfg_for_round(cfg: RunConfig, r_id: int) -> RunConfig:
    """prob_inference loads the round-r model; round 0 dumps live under fr/0r
    (reference prob_inference.py:61-64,150-158)."""
    if r_id == 0:
        return dataclasses.replace(cfg, r_id=0, label_unit="fr")
    return dataclasses.replace(cfg, r_id=r_id)


def run_active_round(
    cfg: RunConfig,
    r_id: int,
    evaluate: bool = True,
    max_iter: Optional[int] = None,
    log: Callable[[str], None] = print,
    device: Union[torch.device, str] = "cuda",
    group: Optional[dist.ProcessGroup] = None,
) -> Dict[str, object]:
    """Run one full round on ``device`` (over the ranks of ``group``, see
    ``cli/commands``); returns {'miou': float} when it evaluated."""
    from lidal_tpu_torch.cli.commands import (
        evaluate_command,
        fused_score_command,
        prob_inference_command,
        score_command,
    )
    from lidal_tpu_torch.runtime.train_loop import run_train

    out: Dict[str, object] = {}

    tc = train_cfg_for_round(cfg, r_id)
    log(f"[round {r_id}] training ({tc.metric_name}/{tc.label_unit})")
    run_train(tc, max_iter=max_iter, device=device, group=group)

    if evaluate:
        log(f"[round {r_id}] evaluating")
        out["miou"] = evaluate_command(tc, device, group)

    sc = dataclasses.replace(cfg, r_id=r_id + 1)
    # Fused single-pass rounds (LiDAL, r >= 1): inference feeds scoring on
    # the device — no prob-map npy round trip on the critical path; same
    # artifacts, same selections.  Round 0 stays staged (its dump also
    # provides the outfeat npys of the reference's r0 contract).
    if cfg.fused_round and cfg.metric_name.startswith("LiDAL") and r_id >= 1:
        log(f"[round {r_id}] fused inference + scoring for round {r_id + 1}")
        fused_score_command(sc, device, group)
        return out

    ic = inference_cfg_for_round(cfg, r_id)
    log(f"[round {r_id}] multi-view prob inference")
    prob_inference_command(ic, device, group)

    log(f"[round {r_id}] scoring + selection for round {r_id + 1}")
    score_command(sc, device, group)
    return out


def run_experiment(
    cfg: RunConfig,
    rounds: int,
    evaluate: bool = True,
    max_iter: Optional[int] = None,
    log: Callable[[str], None] = print,
    device: Union[torch.device, str] = "cuda",
    group: Optional[dist.ProcessGroup] = None,
) -> List[Dict[str, object]]:
    """Rounds 0..rounds-1 of the full active-learning loop."""
    return [
        run_active_round(cfg, r, evaluate=evaluate, max_iter=max_iter, log=log, device=device, group=group)
        for r in range(rounds)
    ]
