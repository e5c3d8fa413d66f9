"""Plain reference of a fused LiDAL round (reference ``score/prob_inference.py``
and ``score/sv_level/LiDAL.py``), written without any code of the program.

* a frame's probabilities: the mean over ``views`` augmented views of the
  softmax of the eval-mode model's voxel logits, projected to the points
  (a point whose voxel was dropped, or that is padding, gets the softmax
  of zeros); each frame's views are drawn from a CPU generator seeded from
  ``SeedSequence([seed, frame index])``;
* a frame's per-point inter-frame divergence and entropy against its 24
  neighbours (12 before, 12 after, with the reference's reflection at the
  sequence's ends): for each neighbour, a point matched to its nearest
  registered neighbour point within 0.1 m adds that point's probability to
  the sum and ``sum_c kl_div(q + 1e-5, n + 1e-5)`` to the divergence; the
  entropy is of the averaged probability, the divergence is divided by the
  matches;
* per-supervoxel means, point counts and centres;
* the greedy selection: AL by highest divergence within a 1 % point budget,
  supervoxels within 5 m of a chosen one replacing it when their entropy is
  higher; SL by lowest nonzero divergence, keeping the lower entropy, over
  the supervoxels unflagged before the old pseudo labels are cleared.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from scipy.spatial import cKDTree

from lidal_bench.reference import data as rdata
from lidal_bench.reference.model import Maps

EPS = 1e-5
NEI_NUM = 24
DIS = 0.1
SV_DIS = 5.0


def view_generator(seed: int, index: int) -> torch.Generator:
    mixed = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed) & (2**63 - 1))


@torch.no_grad()
def frame_probs(model, xyz: np.ndarray, sig: np.ndarray, seed: int, index: int, cfg: Dict, views: int, device,
                levels: list = None):
    """[point_cap, C] mean probabilities of one frame's ``views`` views;
    each view's voxels and overflow per level appended to ``levels``."""
    cap = cfg["point_cap"]
    n = min(len(xyz), cap)
    x = torch.zeros((1, cap, 3), device=device)
    s = torch.zeros((1, cap), device=device)
    v = torch.zeros((1, cap), dtype=torch.bool, device=device)
    x[0, :n], s[0, :n], v[0, :n] = torch.from_numpy(xyz[:n]).to(device), torch.from_numpy(sig[:n]).to(device), True
    draws = rdata.draw_augment(view_generator(seed, index), views)
    frames, points, feats = [], [], []
    for k in range(views):
        d = rdata.Draws(*(t[k:k + 1] for t in draws))
        xa, coords, ok = rdata.voxel_coords(x, v, d, cfg["scale"], cfg["full_scale"])
        pts = ok[0].nonzero()[:, 0]
        fr = rdata.build_frame(coords[0, pts], cfg["level_caps"])
        if levels is not None:
            levels.append((rdata.level_counts(fr)[0], fr.overflow))
        src = pts[fr.first]
        feats.append(torch.cat([xa[0, src], s[0, src, None]], 1))
        frames.append(fr)
        points.append(pts)
    maps = Maps(frames)  # the views in one batch: eval-mode rows do not mix
    logits = model(torch.cat(feats), maps, frames)
    total = torch.zeros((cap, cfg["num_classes"]), dtype=torch.float64, device=device)
    for k, (fr, pts) in enumerate(zip(frames, points)):
        point_logits = torch.zeros((cap, cfg["num_classes"]), device=device)
        kept = fr.inverse >= 0
        point_logits[pts[kept]] = logits[maps.off[0][k]:maps.off[0][k + 1]][fr.inverse[kept]]
        total += torch.softmax(point_logits, dim=-1).double()
    return (total / views).float()


def neighbor_ids(fi: int, n: int, nei: int = NEI_NUM) -> List[int]:
    """LiDAL.py:41-42: 12 before and 12 after, reflected at the ends (clamped
    into the sequence)."""
    half = nei // 2
    ids = [fi - o - 1 if fi - o - 1 >= 0 else half + o + 1 for o in range(half)]
    ids += [fi + o + 1 if fi + o + 1 <= n - 1 else n - 2 - half - o for o in range(half)]
    return [min(max(i, 0), n - 1) for i in ids]


def frame_scores(q_prob: np.ndarray, q_xyz: np.ndarray, neighbours: Sequence) -> tuple:
    """Per-point (divergence, entropy), float64; ``neighbours``: (prob, xyz) per
    listed neighbour, duplicates included."""
    q = q_prob.astype(np.float64)
    qe = q + EPS
    sum_prob = q.copy()
    interd = np.zeros(len(q))
    count = np.ones(len(q))
    for prob, xyz in neighbours:
        dist, idx = cKDTree(xyz.astype(np.float64)).query(q_xyz.astype(np.float64), k=1)
        m = dist <= DIS
        nb = prob[idx[m]].astype(np.float64)
        ne = nb + EPS
        interd[m] += (qe[m] * np.log(qe[m] / ne) - qe[m] + ne).sum(1)
        sum_prob[m] += nb
        count[m] += 1
    avg = sum_prob / count[:, None]
    intere = -np.where(avg > 0, avg * np.log(np.where(avg > 0, avg, 1.0)), 0.0).sum(1)
    interd = np.where(count > 1, interd / np.maximum(count - 1, 1), interd)
    return interd, intere


def sv_means(interd, intere, point2sv, n_sv, xyz):
    cnt = np.bincount(point2sv, minlength=n_sv).astype(np.float64)
    den = np.maximum(cnt, 1)
    d = np.bincount(point2sv, weights=interd, minlength=n_sv) / den
    e = np.bincount(point2sv, weights=intere, minlength=n_sv) / den
    ctr = np.stack([np.bincount(point2sv, weights=xyz[:, k].astype(np.float64), minlength=n_sv) / den
                    for k in range(3)], 1)
    return d, e, cnt.astype(np.int64), ctr


def _greedy(flags, interds, interes, pnums, centers, limit, target, ascending, keep_higher, skip_zero, ids):
    scores = interds[ids]
    order = np.argsort(scores)
    if not ascending:
        order = order[::-1]
    chosen: List[int] = []
    for i in order:
        if skip_zero and scores[i] == 0:
            continue
        sv = ids[i]
        clash = None
        for c in chosen:
            if np.sqrt(np.square(centers[sv] - centers[c]).sum()) < SV_DIS:
                clash = c
                break
        if clash is not None:
            if (interes[clash] < interes[sv]) if keep_higher else (interes[clash] > interes[sv]):
                flags[sv], flags[clash] = target, 0
                chosen.remove(clash)
                chosen.append(sv)
                limit = limit + pnums[clash] - pnums[sv]
            continue
        limit -= int(pnums[sv])
        if limit < 0:
            break
        flags[sv] = target
        chosen.append(sv)
    return flags


def select(prev_flags, interds, interes, pnums, centers, train_point_num, share: float = 0.01) -> np.ndarray:
    flags = prev_flags.astype(np.int64).copy()
    limit = round(share * train_point_num)
    flags = _greedy(flags, interds, interes, pnums, centers, limit, 1, False, True, False, np.where(flags == 0)[0])
    candidates = np.where(flags == 0)[0]
    flags[flags == 2] = 0
    return _greedy(flags, interds, interes, pnums, centers, limit, 2, True, False, True, candidates)
