"""Frame-level active-selection scorers + top-k selection (port of
``lidal_tpu/active/frame_level.py``).

Reference parity (``score/frame_level/*.py``) with one documented divergence:
the reference's pooled scorers pre-fill the score array with zeros sized like the
flag array and then *append* the real scores, so the indices used for selection
point into the zero prefix and the selection degenerates to argpartition over
zeros (SURVEY.md quirk 1).  Here scores are aligned index-for-index with frames —
the intended semantics.  A second divergence: classical margin sampling selects
the *smallest* margin; the reference selects the largest (quirk 2).  Both are
exposed via ``margin_largest``.

The three per-frame scores are plain functions on tensors and run where the
prob map lies (the card in a round); selection is a host argpartition
(reference softmax_entropy.py:104-113), numpy copied line for line.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


# ----- per-frame scores (device) ------------------------------------------------------


def _masked_mean(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return x.mean()
    v = valid.to(torch.float32)
    return (x * v).sum() / v.sum().clamp_min(1.0)


def entropy_score(prob: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean point softmax entropy, natural log (scipy.stats.entropy parity;
    reference softmax_entropy.py:34).  prob [P, C] must be normalized."""
    p = prob.to(torch.float32)
    # 0 * log(0) counts as 0: the log sees 1 wherever p is not positive
    ent = -torch.where(p > 0, p * torch.log(torch.where(p > 0, p, 1.0)), 0.0).sum(dim=-1)
    return _masked_mean(ent, valid)


def margin_score(prob: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean (p1 - p2) margin (reference margin_sampling.py:33-35)."""
    top2 = torch.topk(prob.to(torch.float32), 2, dim=-1).values
    return _masked_mean(top2[..., 0] - top2[..., 1], valid)


def least_confidence_score(prob: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean max-probability (reference least_confidence_sampling.py:33-36);
    select the SMALLEST of these."""
    return _masked_mean(prob.to(torch.float32).max(dim=-1).values, valid)


def segment_entropy_score(pred: np.ndarray, point2sv: np.ndarray, class_num: int) -> float:
    """Point-weighted sum over supervoxels of the label-histogram entropy (base 2)
    of argmax predictions (reference segment_entropy.py:40-50).  Points without a
    supervoxel (point2sv == -1) are excluded from supervoxels but still count in
    the frame's point total, like the reference's ``pred.shape[0]`` denominator."""
    n = pred.shape[0]
    if n == 0:
        return 0.0
    m = point2sv >= 0
    if not m.any():
        return 0.0
    sv = point2sv[m].astype(np.int64)
    n_sv = int(sv.max()) + 1
    hist = np.zeros((n_sv, class_num), np.float64)
    np.add.at(hist, (sv, pred[m].astype(np.int64)), 1.0)
    pnums = hist.sum(1)
    q = hist / np.maximum(pnums[:, None], 1.0)
    sege = -(q * np.log2(q + 1e-12)).sum(1)
    return float((sege * pnums).sum() / n)


# ----- selection (host) ---------------------------------------------------------------


def select_top_frames(
    frame_flag: np.ndarray,
    scores: np.ndarray,
    frac: float = 0.01,
    largest: bool = True,
) -> np.ndarray:
    """Add round(frac * n_frames) unlabeled frames with the most extreme scores
    (reference softmax_entropy.py:104-113).  Returns the updated flag array."""
    flag = frame_flag.astype(bool).copy()
    unlabeled = np.where(~flag)[0]
    s = scores[unlabeled]
    num_add = int(round(frac * flag.shape[0]))
    num_add = min(num_add, len(unlabeled))
    if num_add == 0:
        return flag
    if largest:
        sel = np.argpartition(s, -num_add)[-num_add:]
    else:
        sel = np.argpartition(s, num_add - 1)[:num_add]
    flag[unlabeled[sel]] = True
    return flag


def select_top_frames_reference(
    frame_flag: np.ndarray,
    largest: bool = True,
    frac: float = 0.01,
) -> np.ndarray:
    """VERBATIM reference selection under quirk 1: the reference pre-fills its
    score array with ``np.zeros_like(all_frame_flag)`` and then APPENDS the real
    scores (softmax_entropy.py:83,101), so ``all_scores[unlabeled_ids]`` reads
    the zero prefix and selection degenerates to ``np.argpartition`` over an
    all-zeros array (``:106-111``) — a deterministic introselect tie order that
    ignores the computed scores.  ``largest`` False reproduces CONF's
    ``argpartition(s, num_add)[:num_add]`` (least_confidence_sampling.py:110,
    kth = num_add, not num_add - 1)."""
    flag = frame_flag.astype(bool).copy()
    unlabeled = np.where(~flag)[0]
    num_add = round(frac * flag.shape[0])  # python round, like the reference
    num_add = min(num_add, len(unlabeled))  # guard (the reference would crash)
    if num_add == 0:
        return flag
    zeros = np.zeros(len(unlabeled), np.float32)
    if largest:
        sel = np.argpartition(zeros, -num_add)[-num_add:]
    else:
        sel = np.argpartition(zeros, num_add)[:num_add]
    flag[unlabeled[sel]] = True
    return flag


def select_random_frames(
    frame_flag: np.ndarray, frac: float = 0.01, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Frame-level RAND (reference frame_level/RAND.py:38-42; with-replacement
    draw reproduced — can add < frac unique frames)."""
    rng = rng or np.random.default_rng(0)
    flag = frame_flag.astype(bool).copy()
    num_add = int(round(frac * flag.shape[0]))
    unlabeled = np.where(~flag)[0]
    if len(unlabeled) == 0 or num_add == 0:
        return flag
    sel = rng.choice(unlabeled, num_add)
    flag[sel] = True
    return flag


def core_set_select(
    all_feats: np.ndarray,  # [n_frames, F] mean outfeat per frame (core_set.py:65-70)
    frame_flag: np.ndarray,
    frac: float = 0.01,
) -> np.ndarray:
    """k-Center-Greedy (reference core_set.py:74-92): iteratively add the frame
    with the max min-distance to the selected set."""
    flag = frame_flag.astype(bool).copy()
    labeled = np.where(flag)[0]
    if len(labeled) == 0:
        raise ValueError("core-set needs a non-empty labeled set")
    f = all_feats.astype(np.float64)
    d = np.linalg.norm(f[:, None, :] - f[labeled][None, :, :], axis=-1)
    min_dist = d.min(axis=1)
    num_add = int(round(frac * flag.shape[0]))
    for _ in range(num_add):
        ind = int(np.argmax(min_dist))
        assert not flag[ind]
        flag[ind] = True
        nd = np.linalg.norm(f - f[ind][None, :], axis=-1)
        min_dist = np.minimum(min_dist, nd)
    return flag
