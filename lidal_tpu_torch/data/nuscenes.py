"""nuScenes adapter without the devkit: native JSON-table parsing + manifests
(the port's own numpy copy of ``lidal_tpu/data/nuscenes.py``; the manifest
cache holds plain dicts and numpy arrays, so either package reads the other's).

Reference parity: ``dataset/nu_dataset.py`` (32 -> 16 class learning map, 5-column
.bin reader, uint8 lidarseg labels) and ``dataset/nu_dataloader.py:32-57`` (scene ->
sample enumeration cached as a manifest) and ``dataset/prepare_kdtree_nu.py:27-38``
(sensor -> ego -> global pose composition from calibrated_sensor + ego_pose
quaternions).  The nuscenes-devkit is not a dependency: the v1.0 tables are plain
JSON and are parsed directly.

Splits: the official 700/150 scene-name lists live in the devkit
(``nuscenes.utils.splits.create_splits_scenes``).  Provide them via a
``splits.json`` file ({"train": [...], "val": [...]}) generated once with the
devkit, or fall back to a deterministic sorted 85/15 split (documented
divergence; only affects which scenes are train vs val, not any algorithm).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

# 32 raw categories -> 16 train ids + 255 ignore (reference nu_dataset.py:61-94).
LEARNING_MAP = {
    1: 255, 5: 255, 7: 255, 8: 255, 10: 255, 11: 255, 13: 255, 19: 255, 20: 255,
    0: 255, 29: 255, 31: 255,
    9: 0, 14: 1, 15: 2, 16: 2, 17: 3, 18: 4, 21: 5,
    2: 6, 3: 6, 4: 6, 6: 6,
    12: 7, 22: 8, 23: 9, 24: 10, 25: 11, 26: 12, 27: 13, 28: 14, 30: 15,
}

NUM_CLASSES = 16
IGNORE = 255


def build_label_map() -> np.ndarray:
    label_map = np.full(100, IGNORE, np.int32)  # nu_dataset.py:110-112
    for k, v in LEARNING_MAP.items():
        label_map[k] = v
    return label_map


_LABEL_MAP = build_label_map()


def quaternion_to_rotation(q) -> np.ndarray:
    """[w, x, y, z] -> 3x3 rotation (pyquaternion convention)."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def pose_matrix(rotation_q, translation) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = quaternion_to_rotation(rotation_q)
    m[:3, 3] = translation
    return m


def _load_table(root: str, version: str, name: str) -> list:
    with open(os.path.join(root, version, f"{name}.json")) as f:
        return json.load(f)


def build_manifest(
    root: str, version: str = "v1.0-trainval", cache_path: Optional[str] = None
) -> Dict[str, List[dict]]:
    """scene_name -> ordered list of frame entries.

    Entry: {lidar_path, lidarseg_path, global_pose (4x4 sensor->global), token}.
    Cached as a pickle (reference nu_dataloader.py:32-57 caches file lists).
    """
    if cache_path and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)

    scenes = _load_table(root, version, "scene")
    samples = {s["token"]: s for s in _load_table(root, version, "sample")}
    sample_datas = _load_table(root, version, "sample_data")
    ego_poses = {p["token"]: p for p in _load_table(root, version, "ego_pose")}
    calibs = {c["token"]: c for c in _load_table(root, version, "calibrated_sensor")}
    try:
        lidarsegs = {
            l["sample_data_token"]: l for l in _load_table(root, version, "lidarseg")
        }
    except FileNotFoundError:
        lidarsegs = {}

    # keyframe LIDAR_TOP sample_data per sample
    lidar_by_sample = {}
    for sd in sample_datas:
        if sd.get("is_key_frame") and "LIDAR_TOP" in sd.get("filename", "").upper().replace(
            "/", "_"
        ):
            lidar_by_sample[sd["sample_token"]] = sd

    manifest: Dict[str, List[dict]] = {}
    for scene in scenes:
        entries = []
        tok = scene["first_sample_token"]
        while tok:
            sample = samples[tok]
            sd = lidar_by_sample.get(tok)
            if sd is not None:
                cal = calibs[sd["calibrated_sensor_token"]]
                ego = ego_poses[sd["ego_pose_token"]]
                sensor2ego = pose_matrix(cal["rotation"], cal["translation"])
                ego2global = pose_matrix(ego["rotation"], ego["translation"])
                ls = lidarsegs.get(sd["token"])
                entries.append(
                    {
                        "lidar_path": os.path.join(root, sd["filename"]),
                        "lidarseg_path": os.path.join(root, ls["filename"]) if ls else None,
                        "global_pose": ego2global @ sensor2ego,
                        "token": sd["token"],
                    }
                )
            tok = sample["next"]
        manifest[scene["name"]] = entries

    if cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        tmp = f"{cache_path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(manifest, f)
        os.replace(tmp, cache_path)  # ranks building it at once never read a partial file
    return manifest


def load_splits(
    scene_names: List[str], splits_path: Optional[str] = None
) -> Tuple[List[str], List[str]]:
    """(train_scenes, val_scenes).  Precedence: an explicit splits.json
    override; the devkit (if installed); the official split shipped in-repo
    (``nuscenes_splits.OFFICIAL_VAL``, the devkit's public constant); a
    deterministic sorted 85/15 split with a warning as the last resort (only
    reached for scene sets disjoint from trainval, e.g. synthetic tests)."""
    if splits_path and os.path.exists(splits_path):
        with open(splits_path) as f:
            sp = json.load(f)
        return list(sp["train"]), list(sp["val"])
    try:  # devkit first: authoritative if the user installed it
        from nuscenes.utils.splits import create_splits_scenes

        sp = create_splits_scenes()
        have = set(scene_names)
        train = [s for s in sp["train"] if s in have]
        val = [s for s in sp["val"] if s in have]
        if train or val:
            return train, val
    except ImportError:
        pass
    from lidal_tpu_torch.data.nuscenes_splits import official_split

    official = official_split(scene_names)
    if official is not None:
        return official
    import warnings

    warnings.warn(
        "nuScenes splits.json not found: using a deterministic 85/15 scene split, "
        "NOT the official devkit split"
    )
    names = sorted(scene_names)
    k = int(round(len(names) * 0.85))
    return names[:k], names[k:]


def read_frame(entry: dict, with_labels: bool = True):
    """5-column .bin -> xyz [n,3] f32, sig [n] f32, labels [n] int32 or None
    (reference nu_dataset.py:121-132)."""
    raw = np.fromfile(entry["lidar_path"], dtype=np.float32).reshape(-1, 5)
    xyz = raw[:, :3]
    sig = raw[:, 3]
    labels = None
    if with_labels and entry.get("lidarseg_path"):
        lab = np.fromfile(entry["lidarseg_path"], dtype=np.uint8).reshape(-1)
        labels = _LABEL_MAP[lab].astype(np.int32)
    return xyz, sig, labels
