"""ReDAL baseline: region information scores + diversity-aware selection (the
port's own copy of ``lidal_tpu/active/redal.py``, numpy only, line for line but for one hoisted selection in
``sv_scores_and_feats``).

Reference parity: ``score/sv_level/ReDAL.py`` — per-point information score
``alpha * softmax-entropy(base 2) + gamma * surface-variation`` (alpha=1.0,
gamma=0.05, ``:13-21,63-67``), per-supervoxel mean score and mean 96-d feature
(``:74-79``), then greedy diversity: sort desc, trim to top 10%, KMeans-150 over
region feats, multiplicative importance decay 0.95 per cluster visit, re-sort,
budgeted select (``:198-242``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

ALPHA = 1.0
BETA = 0.0
GAMMA = 0.05
NUM_CLUSTERS = 150
DECAY_RATE = 0.95
TRIM_RATE = 0.1
FT_DIM = 96


def point_information_score(prob: np.ndarray, curvature: np.ndarray) -> np.ndarray:
    """[p] information score (ReDAL.py:63-67): entropy is mean of per-class
    ``-p*log2(p + 1e-12)`` (note: reference uses np.mean over classes)."""
    uncertain = np.mean(-prob * np.log2(prob + 1e-12), axis=1)
    return ALPHA * uncertain + GAMMA * curvature.astype(np.float32)


def sv_scores_and_feats(
    point_score: np.ndarray,
    outfeat: np.ndarray,  # [p, 96]
    point2sv: np.ndarray,  # [p] frame-local sv index (-1 = none)
    n_sv: int,
):
    """Per-supervoxel mean score / mean feature / point count (ReDAL.py:70-79)."""
    m = point2sv >= 0
    sv = point2sv[m].astype(np.int64)
    cnt = np.bincount(sv, minlength=n_sv).astype(np.float64)
    denom = np.maximum(cnt, 1.0)
    scores = (np.bincount(sv, weights=point_score[m], minlength=n_sv) / denom).astype(np.float32)
    feat_m = outfeat[m]  # selected once: the reference selects it anew for each of the 96 channels, same values
    feats = np.stack(
        [np.bincount(sv, weights=feat_m[:, k], minlength=n_sv) / denom for k in range(outfeat.shape[1])],
        axis=1,
    ).astype(np.float32)
    return scores, feats, cnt.astype(np.int64)


def kmeans_labels(
    x: np.ndarray, k: int, seed: int = 0, max_iter: int = 300, tol: float = 1e-4
) -> np.ndarray:
    """Deterministic k-means (k-means++ seeding + Lloyd): cluster labels [n].

    In-repo replacement for the reference's ``sklearn.cluster.KMeans``
    (``ReDAL.py:219-221``): sklearn's exact assignments vary across versions
    and builds, which makes the one selector whose ranking depends on
    clustering non-reproducible; this numpy version is stable and
    self-contained.  Same algorithm family (k-means++ init, Lloyd updates,
    center-shift tolerance) with a seeded ``np.random.Generator``.
    """
    x = np.ascontiguousarray(x, np.float64)
    n = x.shape[0]
    k = min(k, n)
    rng = np.random.default_rng(seed)
    x2 = np.square(x).sum(1)

    # k-means++ seeding
    centers = np.empty((k, x.shape[1]), np.float64)
    centers[0] = x[rng.integers(n)]
    d2 = np.maximum(x2 + np.square(centers[0]).sum() - 2.0 * (x @ centers[0]), 0.0)
    for j in range(1, k):
        tot = d2.sum()
        if tot <= 0:  # all points coincide with chosen centers
            centers[j:] = x[rng.integers(n, size=k - j)]
            break
        centers[j] = x[rng.choice(n, p=d2 / tot)]
        d2 = np.minimum(
            d2, np.maximum(x2 + np.square(centers[j]).sum() - 2.0 * (x @ centers[j]), 0.0)
        )

    labels = np.zeros(n, np.int64)
    for _ in range(max_iter):
        # [n, k] squared distances via the matmul identity (no n*k*d temps)
        dist = x2[:, None] + np.square(centers).sum(1)[None] - 2.0 * (x @ centers.T)
        labels = dist.argmin(1)
        new_centers = centers.copy()
        counts = np.bincount(labels, minlength=k)
        for d in range(x.shape[1]):
            sums = np.bincount(labels, weights=x[:, d], minlength=k)
            new_centers[:, d] = np.where(counts > 0, sums / np.maximum(counts, 1), centers[:, d])
        empty = np.where(counts == 0)[0]
        if len(empty):  # relocate empty clusters to the worst-fit points
            worst = np.argsort(dist[np.arange(n), labels])[::-1][: len(empty)]
            new_centers[empty] = x[worst]
        shift = np.square(new_centers - centers).sum()
        centers = new_centers
        if shift <= tol:
            break
    dist = x2[:, None] + np.square(centers).sum(1)[None] - 2.0 * (x @ centers.T)
    return dist.argmin(1)


class ReDALSelection(NamedTuple):
    sv_flags: np.ndarray
    added: np.ndarray


def select(
    sv_flags: np.ndarray,
    sv_scores: np.ndarray,
    sv_feats: np.ndarray,
    sv_pnums: np.ndarray,
    train_point_num: int,
    budget_frac: float = 0.01,
    num_clusters: int = NUM_CLUSTERS,
    decay_rate: float = DECAY_RATE,
    trim_rate: Optional[float] = TRIM_RATE,
    random_state: int = 0,
) -> ReDALSelection:
    """Importance-reweighted greedy selection (ReDAL.py:198-242)."""
    flags = sv_flags.astype(np.int64).copy()
    before = flags.copy()
    unlabeled_ids = np.where(flags == 0)[0]
    scores = sv_scores[unlabeled_ids]
    feats = sv_feats[unlabeled_ids]

    order = np.argsort(scores)[::-1]
    ids_sorted = unlabeled_ids[order]
    scores_sorted = scores[order].copy()
    feats_sorted = feats[order]

    if trim_rate is not None:
        n = int(feats_sorted.shape[0] * trim_rate)
        ids_sorted = ids_sorted[:n]
        scores_sorted = scores_sorted[:n]
        feats_sorted = feats_sorted[:n]

    k = min(num_clusters, max(1, feats_sorted.shape[0]))
    clusters = kmeans_labels(feats_sorted, k, seed=random_state)

    importance = np.ones(k, np.float64)
    for i in range(feats_sorted.shape[0]):
        c = clusters[i]
        scores_sorted[i] *= importance[c]
        importance[c] *= decay_rate

    order2 = np.argsort(scores_sorted)[::-1]
    ids_final = ids_sorted[order2]

    limit = round(budget_frac * train_point_num)
    for sv_id in ids_final:
        limit -= int(sv_pnums[sv_id])
        if limit < 0:
            break
        flags[sv_id] = 1
    added = np.where((flags == 1) & (before != 1))[0]
    return ReDALSelection(sv_flags=flags, added=added)


def select_random_svs(
    sv_flags: np.ndarray,
    sv_pnums: np.ndarray,
    train_point_num: int,
    budget_frac: float = 0.01,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """SV-level RAND (reference sv_level/RAND.py:57-68): random permutation with
    replacement until the 1% point budget is exhausted."""
    rng = rng or np.random.default_rng(0)
    flags = sv_flags.astype(np.int64).copy()
    n = len(flags)
    limit = int(np.round(budget_frac * train_point_num))
    for idx in rng.choice(n, n):
        if flags[idx] == 0:
            limit -= int(sv_pnums[idx])
            if limit < 0:
                break
            flags[idx] = 1
    return flags
