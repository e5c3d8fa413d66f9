"""SemanticKITTI adapter: label remap, splits, frame IO (a numpy-only copy of
``lidal_tpu/data/semantic_kitti.py``: importing that module runs
``lidal_tpu/data/__init__.py``, which loads JAX).

Reference parity: ``dataset/sk_dataset.py:10-51,66-92`` (34 raw -> 19 train ids +
255 ignore, derived with the same insertion-order algorithm) and
``dataset/sk_dataloader.py:16-17`` (splits).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

TRAIN_SPLIT = ("00", "01", "02", "03", "04", "05", "06", "07", "09", "10")
VAL_SPLIT = ("08",)

LABEL_NAME_MAPPING = {
    0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus",
    15: "motorcycle", 16: "on-rails", 18: "truck", 20: "other-vehicle",
    30: "person", 31: "bicyclist", 32: "motorcyclist", 40: "road", 44: "parking",
    48: "sidewalk", 49: "other-ground", 50: "building", 51: "fence",
    52: "other-structure", 60: "lane-marking", 70: "vegetation", 71: "trunk",
    72: "terrain", 80: "pole", 81: "traffic-sign", 99: "other-object",
    252: "moving-car", 253: "moving-bicyclist", 254: "moving-person",
    255: "moving-motorcyclist", 256: "moving-on-rails", 257: "moving-bus",
    258: "moving-truck", 259: "moving-other-vehicle",
}

KEPT_LABELS = (
    "road", "sidewalk", "parking", "other-ground", "building", "car", "truck",
    "bicycle", "motorcycle", "other-vehicle", "vegetation", "trunk", "terrain",
    "person", "bicyclist", "motorcyclist", "fence", "pole", "traffic-sign",
)

# Train-id order as printed by the reference IoU table (utils/iou_sk.py:7-11).
CLASS_LABELS = (
    "car", "bicycle", "motorcycle", "truck", "other-vehicle", "person",
    "bicyclist", "motorcyclist", "road", "parking", "sidewalk", "other-ground",
    "building", "fence", "vegetation", "trunk", "terrain", "pole", "traffic-sign",
)

NUM_CLASSES = 19
IGNORE = 255


def build_label_map() -> np.ndarray:
    """Raw label id (< 260) -> train id in [0, 19) or 255 (sk_dataset.py:70-92)."""
    reverse: dict = {}
    label_map = np.zeros(260, np.int32)
    cnt = 0
    for label_id, name in LABEL_NAME_MAPPING.items():
        if label_id > 250:
            base = name.replace("moving-", "")
            label_map[label_id] = reverse[base] if base in KEPT_LABELS else IGNORE
        elif label_id == 0:
            label_map[label_id] = IGNORE
        else:
            if name in KEPT_LABELS:
                label_map[label_id] = cnt
                reverse[name] = cnt
                cnt += 1
            else:
                label_map[label_id] = IGNORE
    assert cnt == NUM_CLASSES
    return label_map


_LABEL_MAP = build_label_map()


def list_frames(data_root: str, seqs) -> List[str]:
    """Sorted velodyne .bin paths for the given sequences."""
    files: List[str] = []
    for seq in seqs:
        files += sorted(glob.glob(os.path.join(data_root, seq, "velodyne", "*.bin")))
    return files


def frame_id(path: str) -> Tuple[str, str]:
    """(seq, frame) from a velodyne path (reference prob_inference.py:123-124)."""
    parts = path.split("/")
    return parts[-3], parts[-1][:-4]


def read_frame(path: str, with_labels: bool = True):
    """Read one frame: xyz [N,3] f32, sig [N] f32, labels [N] int32 or None.

    Label handling per reference sk_dataset.py:108-113: low 16 bits, then remap.
    """
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    xyz = raw[:, :3]
    sig = raw[:, 3]
    labels: Optional[np.ndarray] = None
    if with_labels:
        lpath = path.replace("velodyne", "labels")[:-3] + "label"
        lab = np.fromfile(lpath, dtype=np.uint32).reshape(-1) & 0xFFFF
        labels = _LABEL_MAP[lab].astype(np.int32)
    return xyz, sig, labels
