"""The comparison that decides ``correct``: each number the program's run
gives beside the plain reference's, and its limit (``limits/<cell>.json``,
with the readings each was set from).

A round (``loops/round.py`` computes these): ``prob_gap``, the largest
gap between the 8-view probabilities of frames sampled from the seed, as
the window's last call made them, and the reference's; ``score_gap``, the
worst relative gap of the first sampled frame's supervoxel divergence and
entropy means in that call, against the reference's scoring of its own
probabilities of the frame and its 24 neighbours, and of every supervoxel
centre of the sequence; ``selection_mismatch``, the flags where the reference's greedy
selection over that call's aggregates, or any call, differs from the
program's selection or the set-up call's, plus the supervoxel point counts
that differ from the reference's.

Training (the first steps of a run): the largest relative gap of a step's
loss; the worst leaf's gap between the norms of the first gradient as the
optimizer got it; the worst leaf's gap between the norms of the parameters'
change after the checked steps.  A leaf's gap is measured against the
reference's norm of that leaf or of the median leaf, whichever is larger.
The change leaves out leaves whose reference gradient is under a thousandth
of the median leaf's (they move under Adam by round-off alone).
"""

from __future__ import annotations

import json
import statistics
from typing import Dict, List, Tuple

MOVED_FLOOR = 1e-3  # a leaf moves when its reference gradient is at least this share of the median leaf's


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    med = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves)


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers of a train cell."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    leaves = sorted(ref["grad1"])
    med_g = statistics.median(ref["grad1"][n] for n in leaves)
    moved = [n for n in leaves if ref["grad1"][n] >= MOVED_FLOOR * med_g]
    return {"loss_gap": loss, "grad1_gap": leaf_gap(prog["grad1"], ref["grad1"], leaves),
            "delta_gap": leaf_gap(prog["delta"], ref["delta"], moved)}


def limits(path) -> Dict[str, float]:
    """The limits of a cell's file ``limits/<workload>.json``: each number's
    ``limit`` (beside the readings it was set from)."""
    with open(path) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def judge(readings: Dict[str, float], lim: Dict[str, float]) -> Tuple[bool, List[dict]]:
    rows = [{"name": k, "value": readings[k], "limit": lim[k]} for k in sorted(lim)]
    ok = all(r["value"] == r["value"] and r["value"] <= r["limit"] for r in rows)  # NaN fails
    return ok, rows
