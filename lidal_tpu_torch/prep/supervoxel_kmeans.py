"""Size-balanced k-means supervoxel partition (port of
``lidal_tpu/prep/supervoxel_kmeans.py``, numpy and the native library).

Reference parity: ``dataset/prepare_supervoxel_kmeans_sk.py:17`` uses
``KMeansConstrained(n_clusters=20, size_min=0.95*n/20, size_max=1.05*n/20,
n_init=1, max_iter=1, random_state=0)`` (min-cost-flow assignment).  Here:
deterministic kmeans++ seeding + capacity-constrained greedy assignment
(points ordered by their regret if denied their nearest center), which matches
the ±5% size semantics without the min-cost-flow dependency.  Partition identity
is an input artifact, not a scored quantity — algorithm-family parity is what
matters (document-and-diverge).
"""

from __future__ import annotations

import os
import numpy as np

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.data.selection import frame_name, save_sv_info
from lidal_tpu_torch.prep.native import balanced_kmeans_native
from lidal_tpu_torch.runtime.paths import Paths, ensure_dir

N_CLUSTERS = 20  # reference prepare_supervoxel_kmeans_sk.py:17
SIZE_TOL = 0.05


def _kmeanspp_init(xyz: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    n = len(xyz)
    centers = np.empty((k, 3), xyz.dtype)
    centers[0] = xyz[rng.integers(n)]
    d2 = np.square(xyz - centers[0]).sum(1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        centers[i] = xyz[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.square(xyz - centers[i]).sum(1))
    return centers


def balanced_kmeans(
    xyz: np.ndarray,
    n_clusters: int = N_CLUSTERS,
    size_tol: float = SIZE_TOL,
    seed: int = 0,
    lloyd_iters: int = 1,
    prefer_native: bool = True,
) -> np.ndarray:
    """Partition [n, 3] points into ``n_clusters`` groups of size n/k * (1 ± tol).

    Runs the C++ implementation (csrc/balanced_kmeans.cpp, ``prep/native.py``;
    a failed build raises); the python greedy loop below, O(n) interpreted
    per iteration, only when the caller passes ``prefer_native=False``.

    Returns labels [n] int32.
    """
    if prefer_native:
        return balanced_kmeans_native(
            xyz, n_clusters=n_clusters, size_tol=size_tol, lloyd_iters=lloyd_iters, seed=seed,
        )
    n = len(xyz)
    k = min(n_clusters, n)
    rng = np.random.default_rng(seed)
    centers = _kmeanspp_init(xyz, k, rng)
    cap = max(int(n * (1.0 + size_tol) / k), -(-n // k))
    labels = np.zeros(n, np.int32)
    for _ in range(max(1, lloyd_iters)):
        d = np.linalg.norm(xyz[:, None, :] - centers[None], axis=-1)  # [n, k]
        order = np.argsort(d.min(1) - d.mean(1))  # biggest regret first
        counts = np.zeros(k, np.int64)
        pref = np.argsort(d, axis=1)
        for p in order:
            for c in pref[p]:
                if counts[c] < cap:
                    labels[p] = c
                    counts[c] += 1
                    break
        for c in range(k):
            m = labels == c
            if m.any():
                centers[c] = xyz[m].mean(0)
    return labels


def prepare_supervoxels_kmeans(
    cfg: RunConfig,
    seq_frames: dict,  # seq -> list of frame paths
    read_xyz,  # path -> [n, 3] float32
    n_clusters: int = N_CLUSTERS,
    verbose: bool = False,
) -> None:
    """Write per-frame sv_info npz with globally-unique ids + the global id2sv
    index (reference prepare_supervoxel_kmeans_sk.py:54-80)."""
    paths = Paths(cfg)
    gid = 0
    id_seq, id_frame, id_local = [], [], []
    for seq, frames in seq_frames.items():
        out_dir = ensure_dir(paths.supervoxel_dir(seq, "KMeans"))
        for fr in frames:
            xyz = read_xyz(fr)
            labels = balanced_kmeans(xyz, n_clusters=n_clusters)
            k = int(labels.max()) + 1 if len(labels) else 0
            sv_gid = np.arange(gid, gid + k, dtype=np.int64)
            name = frame_name(fr)
            save_sv_info(os.path.join(out_dir, f"{name}.npz"), labels, sv_gid)
            id_seq += [seq] * k
            id_frame += [name] * k
            id_local += list(range(k))
            gid += k
            if verbose:
                print(f"sv {seq}/{name}: {k} clusters")
    base = os.path.join(cfg.processing_root, cfg.dataset_name, "super_voxel", "KMeans")
    ensure_dir(base)
    np.savez_compressed(
        os.path.join(base, "id2sv.npz"),
        seq=np.array(id_seq),
        frame=np.array(id_frame),
        local=np.array(id_local, np.int64),
    )
