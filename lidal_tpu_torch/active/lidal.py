"""LiDAL: inter-frame divergence/entropy scoring + greedy AL/SL selection
(port of ``lidal_tpu/active/lidal.py``).

Reference parity: ``score/sv_level/LiDAL.py`` end to end —

* neighbor ids: 12 before + 12 after with the reference's end-of-sequence
  reflection arithmetic reproduced verbatim (``LiDAL.py:41-42``);
* per-point accumulation over matched neighbors (``:59-81``):
  ``sum_prob += nei_prob[nn]``, ``interd += sum_c kl_div(q+eps, n+eps)``,
  inter-frame entropy of the view-averaged probability, divergence normalized by
  match count (``scipy.special.kl_div(x, y) = x*log(x/y) - x + y``);
* per-supervoxel means + point counts + centers (+ seq offset 1000 per sequence
  index, ``:218``);
* greedy AL selection (highest divergence, 1% point budget, 5 m center dedup
  keeping the higher-entropy supervoxel with swap side effects) and SL
  pseudo-label selection (lowest nonzero divergence, dedup keeping lower entropy,
  flag=2 after resetting old pseudo flags) — ``:230-325``, order-faithful.

The NN matching and the accumulation run on the device; the greedy loops are
serial host code (numpy), copied from the JAX package line for line so that
the same scores give the same flags.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Union

import numpy as np
import torch

from lidal_tpu_torch.active.nn_match import (
    HashGrid,
    PreparedQueries,
    build_grid,
    nn_query_band,
    prepare_queries,
    prepared_from_grid,
    stack_grids,
)

EPSILON = 1e-5  # reference LiDAL.py:64
NEI_NUM = 24  # reference LiDAL.py:119
DIS_THRESH = 0.1  # reference LiDAL.py:121
SV_DIS_THRESH = 5.0  # reference LiDAL.py:230
BUDGET_FRAC = 0.01  # reference LiDAL.py:240,291


def neighbor_ids(frame_id: int, num_frames: int, nei_num: int = NEI_NUM) -> List[int]:
    """Reference LiDAL.py:41-42, reproduced including the reflection quirks.

    For sequences with fewer than ~(nei_num + 2) frames the reference arithmetic
    produces out-of-range indices (it would crash there); ids are clamped into
    [0, num_frames - 1] — a divergence only where the reference is broken.
    """
    half = int(nei_num / 2)
    ids = [
        (frame_id - off - 1) if (frame_id - off - 1) >= 0 else (half + off + 1)
        for off in range(half)
    ]
    ids += [
        (frame_id + off + 1)
        if (frame_id + off + 1) <= (num_frames - 1)
        else (num_frames - 2 - half - off)
        for off in range(half)
    ]
    return [min(max(i, 0), num_frames - 1) for i in ids]


def _finalize(sum_prob, interd, map_count):
    """LiDAL.py:74-81: entropy of view/neighbor-averaged prob; mean divergence."""
    avg = sum_prob / map_count[:, None]
    intere = -torch.where(avg > 0, avg * torch.log(avg), 0.0).sum(dim=-1)
    mc = map_count - 1.0
    interd = torch.where(mc > 0, interd / mc.clamp_min(1.0), interd)
    return interd, intere


def _accumulate_and_unsort(pq: PreparedQueries, q_prob_s, nei_probs, grids: HashGrid, weights):
    """Band NN over all stacked slots (ONE kernel launch) + KL/entropy
    accumulation slot by slot, in slot order (as the JAX package's ``lax.scan``
    does, so the f32 sums compare tightly); results put back in original point
    order by an indexed write through ``s_qidx`` (a permutation).

    ``weights`` [S] carries per-slot multiplicity (the reference's
    end-of-sequence neighbor reflection can list the same frame twice —
    LiDAL.py:41-42; unused ring slots and the query's own slot ride at 0).

    Exact-NN guarantee: the band scan has no candidate caps, so matches
    reproduce the reference KD-tree (``LiDAL.py:66``) for every point."""
    d2_all, row_all = nn_query_band(grids, pq)  # [S, p] in sorted query order
    cap = grids.src_idx.shape[1]
    thresh = torch.full((), DIS_THRESH, dtype=torch.float32, device=d2_all.device)
    weights = weights.to(torch.float32)

    sum_prob = q_prob_s.clone()  # LiDAL.py:63: starts as the query prob copy
    interd = torch.zeros(q_prob_s.shape[:1], dtype=torch.float32, device=q_prob_s.device)
    map_count = torch.ones_like(interd)  # LiDAL.py:61
    qe = q_prob_s + EPSILON
    log_qe = torch.log(qe)

    for s in range(d2_all.shape[0]):
        match = (torch.sqrt(d2_all[s]) <= thresh) & pq.s_ok
        npb = nei_probs[s][row_all[s].clamp_max(cap - 1).long()]  # [p, c]; grid-sorted probs
        ne = npb + EPSILON
        # scipy.special.kl_div(x, y) = x*log(x/y) - x + y, over classes (LiDAL.py:71)
        kl = (qe * (log_qe - torch.log(ne)) - qe + ne).sum(dim=-1)
        wf = torch.where(match, weights[s], 0.0)
        sum_prob = sum_prob + npb * wf[:, None]
        interd = interd + wf * kl
        map_count = map_count + wf

    interd, intere = _finalize(sum_prob, interd, map_count)
    out = torch.empty((2,) + interd.shape, dtype=torch.float32, device=interd.device)
    out[:, pq.s_qidx.long()] = torch.stack([interd, intere])
    return out


def score_slot(ring_state, slot: int, weights) -> torch.Tensor:
    """Production entry: score ring slot ``slot`` against all slots weighted by
    ``weights`` [S] (its own slot at 0).  A ring-resident frame's grid IS its
    cell-sort (``nn_match.prepared_from_grid``), so scoring uploads nothing.
    Returns stacked [2, cap] (interd, intere) in the frame's ORIGINAL point
    order: the runner pulls both score vectors in one transfer."""
    grids, probs = ring_state
    pq = prepared_from_grid(HashGrid(*(f[slot] for f in grids)))
    weights = torch.as_tensor(weights, device=probs.device)
    return _accumulate_and_unsort(pq, probs[slot], probs, grids, weights)


def score_frame(
    q_prob: np.ndarray,  # [p, c] view-averaged probability map of the query frame
    q_xyz: np.ndarray,  # [p, 3] pose-registered (sequence-global) coords
    nei_probs: Sequence[np.ndarray],
    nei_grids: Sequence[HashGrid],
):
    """Per-point inter-frame divergence + entropy against all neighbor frames.

    Convenience list API (tests): ``nei_probs`` in ORIGINAL point order;
    stacks + grid-sorts on the fly, on the device the grids live on.  The
    runner uses the stacked ring entry."""
    grids = stack_grids(list(nei_grids))
    dev = grids.key_hi.device
    with torch.inference_mode():
        q_prob_t = torch.as_tensor(q_prob, dtype=torch.float32, device=dev)
        q_xyz_t = torch.as_tensor(q_xyz, dtype=torch.float32, device=dev)
        q_valid = torch.ones(q_prob_t.shape[:1], dtype=torch.bool, device=dev)
        cap = grids.src_idx.shape[1]
        nei = torch.zeros((len(nei_probs), cap, q_prob_t.shape[1]), dtype=torch.float32, device=dev)
        for i, p in enumerate(nei_probs):
            nei[i, : p.shape[0]] = torch.as_tensor(p, dtype=torch.float32, device=dev)
        nei = nei.gather(1, grids.src_idx.long()[:, :, None].expand(-1, -1, nei.shape[2]))
        w = torch.ones(len(nei_probs), device=dev)
        pq = prepare_queries(q_xyz_t, q_valid, DIS_THRESH)
        q_prob_s = q_prob_t[pq.s_qidx.long()]  # accumulate in sorted order; unsort once
        out = _accumulate_and_unsort(pq, q_prob_s, nei, grids, w).cpu().numpy()
    return out[0], out[1]


def sv_aggregate(
    interd: np.ndarray,  # [p]
    intere: np.ndarray,  # [p]
    point2sv: np.ndarray,  # [p] frame-local sv index (-1 = none)
    n_sv: int,
    xyz: np.ndarray = None,  # [p, 3] for centers (first run only)
):
    """Per-supervoxel means (+ pnums/centers) — LiDAL.py:84-103."""
    m = point2sv >= 0
    sv = point2sv[m].astype(np.int64)
    cnt = np.bincount(sv, minlength=n_sv).astype(np.float64)
    denom = np.maximum(cnt, 1.0)
    sv_interd = (np.bincount(sv, weights=interd[m], minlength=n_sv) / denom).astype(np.float32)
    sv_intere = (np.bincount(sv, weights=intere[m], minlength=n_sv) / denom).astype(np.float32)
    out = [sv_interd, sv_intere, cnt.astype(np.int64)]
    if xyz is not None:
        centers = np.stack(
            [np.bincount(sv, weights=xyz[m][:, k], minlength=n_sv) / denom for k in range(3)], 1
        ).astype(np.float32)
        out.append(centers)
    return tuple(out)


class SelectionResult(NamedTuple):
    sv_flags: np.ndarray  # updated flags (0 / 1 human / 2 pseudo)
    al_added: np.ndarray  # ids newly flagged 1
    sl_added: np.ndarray  # ids newly flagged 2


def _greedy_select(
    sv_flags: np.ndarray,
    sv_interds: np.ndarray,
    sv_interes: np.ndarray,
    sv_pnums: np.ndarray,
    sv_centers: np.ndarray,
    point_limit: int,
    target_flag: int,
    ascending: bool,
    keep_higher_entropy: bool,
    skip_zero: bool,
    sv_dis_thresh: float = SV_DIS_THRESH,
    unlabeled_ids: np.ndarray = None,
) -> np.ndarray:
    """One greedy pass (AL: target 1, descending, keep-higher; SL: target 2,
    ascending, keep-lower, skip zero divergence). Mutates and returns sv_flags."""
    if unlabeled_ids is None:
        unlabeled_ids = np.where(sv_flags == 0)[0]
    unlabeled_interds = sv_interds[unlabeled_ids]
    # np.argsort default (quicksort): the reference relies on its exact order
    # only through score ties; the default is kept to match.
    sorted_ids = np.argsort(unlabeled_interds)
    order = sorted_ids if ascending else sorted_ids[::-1]

    added = []
    for idx in order:
        if skip_zero and unlabeled_interds[idx] == 0:
            continue
        sv_id = unlabeled_ids[idx]
        sv_c = sv_centers[sv_id]
        ok = True
        for l_sv_id in list(added):
            dist = float(np.sqrt(np.square(sv_c - sv_centers[l_sv_id]).sum()))
            if dist < sv_dis_thresh:
                ok = False
                better = (
                    sv_interes[l_sv_id] < sv_interes[sv_id]
                    if keep_higher_entropy
                    else sv_interes[l_sv_id] > sv_interes[sv_id]
                )
                if better:
                    sv_flags[sv_id] = target_flag
                    sv_flags[l_sv_id] = 0
                    added.append(sv_id)
                    added.remove(l_sv_id)
                    point_limit = point_limit + sv_pnums[l_sv_id] - sv_pnums[sv_id]
                break
        if ok:
            point_limit -= int(sv_pnums[sv_id])
            if point_limit < 0:
                break
            sv_flags[sv_id] = target_flag
            added.append(sv_id)
    return sv_flags


def select(
    sv_flags: np.ndarray,
    sv_interds: np.ndarray,
    sv_interes: np.ndarray,
    sv_pnums: np.ndarray,
    sv_centers: np.ndarray,
    train_point_num: int,
    budget_frac: float = BUDGET_FRAC,
) -> SelectionResult:
    """Full AL + SL selection (LiDAL.py:230-325)."""
    flags = sv_flags.astype(np.int64).copy()
    before = flags.copy()
    limit = round(budget_frac * train_point_num)

    flags = _greedy_select(
        flags, sv_interds, sv_interes, sv_pnums, sv_centers, limit,
        target_flag=1, ascending=False, keep_higher_entropy=True, skip_zero=False,
    )
    al_added = np.where((flags == 1) & (before != 1))[0]

    # SL candidates are frozen BEFORE the old pseudo flags are reset
    # (LiDAL.py:281-286) — previous-round pseudo SVs are excluded ("alternating
    # schedule": P_i avoids P_{i-1}), even though their flags return to 0.
    sl_candidates = np.where(flags == 0)[0]
    flags[flags == 2] = 0
    flags = _greedy_select(
        flags, sv_interds, sv_interes, sv_pnums, sv_centers, limit,
        target_flag=2, ascending=True, keep_higher_entropy=False, skip_zero=True,
        unlabeled_ids=sl_candidates,
    )
    sl_added = np.where(flags == 2)[0]
    return SelectionResult(sv_flags=flags, al_added=al_added, sl_added=sl_added)


def make_neighbor_grid(
    xyz: np.ndarray,
    cell: float = DIS_THRESH,
    cap: int = None,
    device: Union[torch.device, str] = "cuda",
) -> HashGrid:
    """Build (and pad) a hash grid on ``device`` from a frame's pose-registered points."""
    n = xyz.shape[0]
    cap = cap or n
    pad = np.zeros((cap, 3), np.float32)
    pad[:n] = xyz[:cap]
    valid = np.zeros((cap,), bool)
    valid[: min(n, cap)] = True
    with torch.inference_mode():
        return build_grid(torch.as_tensor(pad, device=device), torch.as_tensor(valid, device=device), cell)
