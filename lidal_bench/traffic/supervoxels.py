"""Size-balanced k-means supervoxels of scan frames, made on the device.

The reference's prep (``dataset/prepare_supervoxel_kmeans_sk.py:17``)
splits each frame's raw xyz into ``KMeansConstrained(n_clusters=20,
size_min=0.95 n/20, size_max=1.05 n/20, n_init=1, max_iter=1)`` clusters:
k-means++ seeds, then one assignment to the seeds under the size limits.
So here: k-means++ seeds drawn from a seeded generator, then Lloyd steps
whose assignment is greedy under a capacity of ``ceil(n / 20)`` points a
cluster (the port's prep, ``prep/supervoxel_kmeans.py``, also assigns
greedily under a capacity).  A greedy assignment alone leaves the last
clusters to fill scattered, where the reference's exact one does not, so
the centres move to their points' means a few times.  Frames are done a
few at a time on the device, padded to the longest.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

CHUNK = 4  # frames at a time: [CHUNK, points, k] float64 distances
ITERS = 8  # Lloyd steps after the seeds, each assignment under the capacity


def _generator(seed: int, first: int, device) -> torch.Generator:
    mixed = np.random.SeedSequence([seed, 6, first]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) & (2**63 - 1))


def _seeds(x: torch.Tensor, valid: torch.Tensor, k: int, g: torch.Generator) -> torch.Tensor:
    """[f, k, 3] k-means++ seeds: the first uniform over a frame's points,
    each next one with probability proportional to the squared distance to
    the nearest seed so far (Gumbel-max draws)."""
    f, n, _ = x.shape
    rows = torch.arange(f, device=x.device)
    w = valid.double()
    seeds = torch.empty((f, k, 3), dtype=x.dtype, device=x.device)
    for j in range(k):
        u = torch.rand((f, n), generator=g, device=x.device, dtype=torch.float64)
        key = torch.where(w > 0, w.log() - (-u.log()).log(), -torch.inf)
        seeds[:, j] = x[rows, key.argmax(1)]
        w = torch.minimum(w, (x - seeds[:, j:j + 1]).square().sum(-1)) * valid
    return seeds


def _capacity_assign(dist: torch.Tensor, valid: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """[f, n] cluster of each point, at most ``cap`` points a cluster: in
    rounds, each point not yet placed proposes to its nearest cluster with
    room, and each cluster takes its nearest proposers while it has room."""
    f, n, k = dist.shape
    dev = dist.device
    rows = torch.arange(f, device=dev)[:, None]
    scale = dist.amax() + 1.0
    out = torch.full((f, n), -1, dtype=torch.long, device=dev)
    room = cap[:, None].expand(f, k).clone()
    for _ in range(k + 1):  # each round fills a cluster or places every proposer
        open_ = valid & (out < 0)
        if not bool(open_.any()):
            break
        cost, choice = torch.where((room > 0)[:, None], dist, torch.inf).min(-1)
        key = torch.where(open_, choice * scale + cost, torch.inf)
        key, order = key.sort(dim=1, stable=True)
        c = choice.gather(1, order)
        proposers = torch.zeros((f, k), dtype=torch.long, device=dev).scatter_add_(
            1, torch.where(open_, choice, 0), open_.long())
        start = proposers.cumsum(1) - proposers
        rank = torch.arange(n, device=dev)[None] - start.gather(1, c)
        take = torch.isfinite(key) & (rank < room.gather(1, c))
        out[rows.expand(f, n)[take], order[take]] = c[take]
        room -= torch.zeros_like(room).scatter_add_(1, torch.where(take, c, 0), take.long())
    return out


def partition(frames_xyz: List[np.ndarray], k: int, seed: int, device) -> List[np.ndarray]:
    """Each frame's ``[n]`` int32 supervoxel ids in ``0..k-1``: ``k`` clusters
    of ``ceil(n / k)`` points but for fewer than ``k`` points short in all,
    so within the reference's 0.95-1.05 n / k from 7,600 points a frame on.
    The same seed gives the same ids."""
    out: List[np.ndarray] = []
    for first in range(0, len(frames_xyz), CHUNK):
        xs = frames_xyz[first:first + CHUNK]
        counts = torch.tensor([len(a) for a in xs], device=device)
        n = int(counts.max())
        x = torch.zeros((len(xs), n, 3), dtype=torch.float64, device=device)
        for i, a in enumerate(xs):
            x[i, :len(a)] = torch.from_numpy(np.asarray(a, np.float64)).to(device)
        valid = torch.arange(n, device=device)[None] < counts[:, None]
        centres = _seeds(x, valid, k, _generator(seed, first, device))
        for it in range(ITERS + 1):
            dist = (x[:, :, None] - centres[:, None]).square().sum(-1)
            ids = _capacity_assign(dist, valid, (counts + k - 1) // k)
            if it < ITERS:  # centres to the means of their points (one-hot products: no atomics)
                hot = torch.nn.functional.one_hot(ids.clamp(min=0), k).double() * valid[..., None]
                centres = hot.transpose(1, 2) @ x / hot.sum(1)[..., None].clamp(min=1)
        out += [ids[i, :len(a)].int().cpu().numpy() for i, a in enumerate(xs)]
        del x, dist
    return out
