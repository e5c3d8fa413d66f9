"""The scan generator at a small ray count."""

import json

import numpy as np
import pytest

from lidal_bench.run import HERE
from lidal_bench.traffic import scan

# raw SemanticKITTI ids whose train id is one of the 19 classes
TRAIN_RAW_IDS = {10, 11, 13, 15, 16, 18, 20, 30, 31, 32, 40, 44, 48, 49, 50, 51, 70, 71, 72, 80, 81,
                 252, 253, 254, 255, 256, 257, 258, 259}


@pytest.fixture(scope="module")
def params():
    p = json.loads((HERE / "traffic" / "train_b5.json").read_text())["scan"]
    return {**p, "beams": 32, "azimuths": 512}


@pytest.fixture(scope="module")
def frames(params):
    return scan.generate(2**40 + 3, 4, params, "cpu")


def test_same_seed_same_frames(params, frames):
    again, poses = scan.generate(2**40 + 3, 4, params, "cpu")
    for (a, b, c), (x, y, z) in zip(frames[0], again):
        assert np.array_equal(a, x) and np.array_equal(b, y) and np.array_equal(c, z)
    assert np.array_equal(poses, frames[1])
    other, other_poses = scan.generate(2**40 + 4, 1, params, "cpu")
    assert not np.array_equal(other[0][0][:100], frames[0][0][0][:100])  # the sensor's noise
    assert np.array_equal(other_poses[0], frames[1][0])  # the same street and path
    street, _ = scan.generate(2**40 + 4, 1, {**params, "scene_seed": params["scene_seed"] + 1}, "cpu")
    assert len(street[0][0]) != len(other[0][0])


def _world(frame, pose):
    return frame[0] @ pose[:3, :3].T + pose[:3, 3]


def test_neighbouring_frames_overlap_under_their_poses(frames):
    (fs, poses) = frames
    cells = [set(map(tuple, np.floor(_world(f, p) / 0.5).astype(np.int64))) for f, p in zip(fs, poses)]
    for a, b in zip(cells, cells[1:]):
        assert len(a & b) / len(a) > 0.5
    # without the poses (sensor coordinates) the ground truth differs: the ego moved 1 m a frame
    assert np.abs(poses[1][:3, 3] - poses[0][:3, 3]).max() > 0.9


def test_voxel_count_falls_level_by_level(frames):
    for xyz, _, _ in frames[0]:
        c = np.floor(xyz * 20.0).astype(np.int64)
        counts = [len(np.unique(c >> k, axis=0)) for k in range(5)]
        assert all(a > b for a, b in zip(counts, counts[1:])), counts


def test_labels_are_raw_ids_of_the_train_classes_and_intensity_in_range(frames):
    for xyz, sig, lab in frames[0]:
        assert len(xyz) > 0.8 * 32 * 512 * 0.5
        assert set(np.unique(lab).tolist()) <= TRAIN_RAW_IDS
        assert sig.min() >= 0 and sig.max() < 1
        assert np.linalg.norm(xyz, axis=1).max() <= 80.2


def _rms_radius(xyz, ids, k):
    return np.mean([np.sqrt(((xyz[ids == j] - xyz[ids == j].mean(0)) ** 2).sum(1).mean()) for j in range(k)])


def test_supervoxels_are_balanced_compact_and_seeded(frames):
    from lidal_bench.traffic import supervoxels

    xyz = [f[0] for f in frames[0]]
    ids = supervoxels.partition(xyz, 20, 2**40 + 5, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(ids, supervoxels.partition(xyz, 20, 2**40 + 5, "cpu")))
    for x, lab in zip(xyz, ids):
        sizes = np.bincount(lab, minlength=20)
        assert len(sizes) == 20 and sizes.sum() == len(x)
        assert 0.95 * len(x) / 20 <= sizes.min() and sizes.max() <= 1.05 * len(x) / 20
        # tighter than 20 equal-count azimuth sectors from the sensor out
        order = np.argsort(np.arctan2(x[:, 1], x[:, 0]), kind="stable")
        sectors = np.empty(len(x), np.int64)
        sectors[order] = np.arange(len(x)) * 20 // len(x)
        assert _rms_radius(x, lab, 20) < 0.9 * _rms_radius(x, sectors, 20)
