"""Pose-registered per-frame point tables (port of ``lidal_tpu/prep/grid.py``,
numpy only).

Reference parity: ``dataset/prepare_kdtree_sk.py:77-88`` builds an sklearn
KDTree per frame over sequence-global coordinates and pickles it; LiDAL scoring
then queries 24 neighbor trees per frame.  Here the per-frame artifact is the
registered float32 point array saved as ``.npz``; the device hash grid
(``active/nn_match.build_grid``) is built from it when the frame enters the
scoring ring.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.data import nuscenes as nu, semantic_kitti as sk
from lidal_tpu_torch.data.selection import frame_name
from lidal_tpu_torch.prep.poses import sequence_poses, transform_points
from lidal_tpu_torch.runtime.paths import Paths, ensure_dir


def prepare_sk_grids(cfg: RunConfig, seqs: Sequence[str] | None = None, verbose: bool = False):
    """Write Processing_files/SK/grid/{seq}/{frame}.npz with registered points."""
    paths = Paths(cfg)
    seqs = seqs or cfg.data.train_split
    for seq in seqs:
        seq_dir = os.path.join(cfg.data_root, seq)
        frames = sk.list_frames(cfg.data_root, [seq])
        if not frames:  # sequence absent from this dataset copy
            continue
        poses = sequence_poses(seq_dir)
        assert len(poses) >= len(frames), (seq, len(poses), len(frames))
        out_dir = ensure_dir(paths.grid_dir(seq))
        for i, fr in enumerate(frames):
            xyz, _, _ = sk.read_frame(fr, with_labels=False)
            gxyz = transform_points(xyz, poses[i]).astype(np.float32)
            name = frame_name(fr)
            np.savez_compressed(os.path.join(out_dir, f"{name}.npz"), xyz=gxyz)
            if verbose:
                print(f"grid {seq}/{name}: {len(gxyz)} pts")


def prepare_nu_grids(cfg: RunConfig, seq_frames: dict | None = None, verbose: bool = False):
    """nuScenes variant: register each keyframe's points via its manifest
    sensor->global pose (reference prepare_kdtree_nu.py:27-38 semantics)."""
    from lidal_tpu_torch.runtime.train_loop import nu_seq_frames

    paths = Paths(cfg)
    seq_frames = seq_frames or nu_seq_frames(cfg)
    for scene, entries in seq_frames.items():
        out_dir = ensure_dir(paths.grid_dir(scene))
        for e in entries:
            xyz, _, _ = nu.read_frame(e, with_labels=False)
            gxyz = transform_points(xyz, e["global_pose"]).astype(np.float32)
            np.savez_compressed(os.path.join(out_dir, f"{frame_name(e)}.npz"), xyz=gxyz)
            if verbose:
                print(f"grid {scene}/{frame_name(e)}: {len(gxyz)} pts")


def load_grid_points(path: str) -> np.ndarray:
    with np.load(path) as z:
        return z["xyz"]
