"""SemanticKITTI pose parsing and sequence-global registration (the port's
own numpy copy of ``lidal_tpu/prep/poses.py``).

Reference parity: ``dataset/prepare_kdtree_sk.py:10-80`` — parse ``calib.txt``
(the ``Tr`` velodyne->camera extrinsic) and ``poses.txt`` (camera trajectory),
then transform each frame's points into sequence-global coordinates via
``Tr^-1 @ pose @ Tr``.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np


def parse_calibration(path: str) -> dict:
    """calib.txt -> {name: 4x4}, with the homogeneous row appended."""
    calib = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, content = line.split(":", 1)
            values = [float(v) for v in content.strip().split()]
            mat = np.zeros((4, 4))
            mat[0, :4] = values[0:4]
            mat[1, :4] = values[4:8]
            mat[2, :4] = values[8:12]
            mat[3, 3] = 1.0
            calib[key.strip()] = mat
    return calib


def parse_poses(path: str, tr: np.ndarray) -> List[np.ndarray]:
    """poses.txt -> list of 4x4 velodyne-frame global poses: Tr^-1 @ P @ Tr."""
    tr_inv = np.linalg.inv(tr)
    poses = []
    with open(path) as f:
        for line in f:
            values = [float(v) for v in line.strip().split()]
            if not values:
                continue
            p = np.zeros((4, 4))
            p[0, :4] = values[0:4]
            p[1, :4] = values[4:8]
            p[2, :4] = values[8:12]
            p[3, 3] = 1.0
            poses.append(tr_inv @ p @ tr)
    return poses


def sequence_poses(seq_dir: str) -> List[np.ndarray]:
    """Velodyne global poses for one sequence directory (containing calib.txt,
    poses.txt)."""
    calib = parse_calibration(os.path.join(seq_dir, "calib.txt"))
    return parse_poses(os.path.join(seq_dir, "poses.txt"), calib["Tr"])


def transform_points(xyz: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Apply a 4x4 pose to [n, 3] points."""
    return xyz @ pose[:3, :3].T + pose[:3, 3]
