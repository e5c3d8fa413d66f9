"""Per-point surface variation (curvature) for the ReDAL baseline (port of
``lidal_tpu/prep/surface_variation.py``).

Reference parity: ``dataset/ReDAL/gen_surface_variation_sk.py:16-40`` — for each
point, the eigenvalues (l1 <= l2 <= l3) of the covariance of its 50 nearest
neighbors give sigma = l1 / (l1 + l2 + l3), clipped at 0.1.  The JAX package
finds the neighbours with sklearn's ``KDTree``; the port with scipy's
``cKDTree`` (scikit-learn is not a dependency of the port).  Both return the
k nearest in ascending distance, so the neighbour sets are the same except
at exactly equal distances; the covariance and ``eigvalsh`` are the same numpy.
"""

from __future__ import annotations

import os

import numpy as np

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.data.selection import frame_name
from lidal_tpu_torch.runtime.paths import Paths, ensure_dir

K_NEIGHBORS = 50  # reference gen_surface_variation_sk.py:31
CLIP = 0.1  # reference gen_surface_variation_sk.py:36


def surface_variation(xyz: np.ndarray, k: int = K_NEIGHBORS, clip: float = CLIP) -> np.ndarray:
    """[n] float32 curvature sigma, clipped."""
    from scipy.spatial import cKDTree

    n = len(xyz)
    k = min(k, n)
    _, idx = cKDTree(xyz).query(xyz, k=k)  # [n, k]
    idx = idx.reshape(n, k)  # k == 1 returns [n]
    nb = xyz[idx]  # [n, k, 3]
    mean = nb.mean(axis=1, keepdims=True)
    d = nb - mean
    cov = np.einsum("nki,nkj->nij", d, d) / k
    ev = np.linalg.eigvalsh(cov)  # ascending [n, 3]
    denom = np.maximum(ev.sum(axis=1), 1e-12)
    sigma = ev[:, 0] / denom
    return np.clip(sigma, None, clip).astype(np.float32)


def prepare_surface_variation(
    cfg: RunConfig, seq_frames: dict, read_xyz, verbose: bool = False
) -> None:
    """Write Processing_files/{DS}/boundary/{seq}/{frame}.npy (ReDAL 'curvature')."""
    paths = Paths(cfg)
    for seq, frames in seq_frames.items():
        out_dir = ensure_dir(paths.boundary_dir(seq))
        for fr in frames:
            xyz = read_xyz(fr)
            sv = surface_variation(xyz)
            name = frame_name(fr)
            np.save(os.path.join(out_dir, f"{name}.npy"), sv)
            if verbose:
                print(f"boundary {seq}/{name}")
