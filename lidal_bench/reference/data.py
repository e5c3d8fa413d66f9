"""Plain reference of a train batch: frame files, label remap, the batch
order, the augmentation draws and the voxel tables of the five levels.

Semantics (reference ``dataset/sk_dataset.py``, ``dataset/sk_dataloader.py``):
34 raw SemanticKITTI ids -> 19 train ids + 255; per epoch the frame list is
shuffled with ``numpy.random.default_rng(seed + epoch)``; each frame gets the
affine ``(I + 0.1 N) * flip_x @ Rz(theta)``, is scaled by ``scale``, shifted
into ``[0, full_scale)^3`` and truncated to voxels; a voxel keeps its first
point (lowest index) and voxels are ordered x-major, the first ``cap`` kept.
A coarse level is ``unique(coords >> 1)`` of the finer level's voxels, again
with its cap.  Written without any code of the program.
"""

from __future__ import annotations

import glob
import math
import os
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

IGNORE = 255

_LABEL_NAMES = {
    0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus", 15: "motorcycle", 16: "on-rails",
    18: "truck", 20: "other-vehicle", 30: "person", 31: "bicyclist", 32: "motorcyclist", 40: "road",
    44: "parking", 48: "sidewalk", 49: "other-ground", 50: "building", 51: "fence", 52: "other-structure",
    60: "lane-marking", 70: "vegetation", 71: "trunk", 72: "terrain", 80: "pole", 81: "traffic-sign",
    99: "other-object", 252: "moving-car", 253: "moving-bicyclist", 254: "moving-person",
    255: "moving-motorcyclist", 256: "moving-on-rails", 257: "moving-bus", 258: "moving-truck",
    259: "moving-other-vehicle",
}
_KEPT = ("road", "sidewalk", "parking", "other-ground", "building", "car", "truck", "bicycle", "motorcycle",
         "other-vehicle", "vegetation", "trunk", "terrain", "person", "bicyclist", "motorcyclist", "fence",
         "pole", "traffic-sign")


def label_map() -> np.ndarray:
    """Raw id -> train id in insertion order of the kept names (moving-x -> x)."""
    out = np.full(260, IGNORE, np.int32)
    ids = {}
    for raw, name in _LABEL_NAMES.items():
        if raw > 250:
            base = name.replace("moving-", "")
            out[raw] = ids.get(base, IGNORE)
        elif raw != 0 and name in _KEPT:
            ids[name] = len(ids)
            out[raw] = ids[name]
    return out


_MAP = label_map()


def read_frame(path: str):
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    lab = np.fromfile(path.replace("velodyne", "labels")[:-3] + "label", dtype=np.uint32) & 0xFFFF
    return raw[:, :3], raw[:, 3], _MAP[lab].astype(np.int32)


def frame_files(data_root: str, seq: str) -> List[str]:
    return sorted(glob.glob(os.path.join(data_root, seq, "velodyne", "*.bin")))


def epoch_batches(files: Sequence[str], seed: int, epoch: int, batch: int) -> List[List[str]]:
    order = list(files)
    np.random.default_rng(seed + epoch).shuffle(order)
    return [order[i: i + batch] for i in range(0, len(order), batch)]


def padded_batch(paths: Sequence[str], point_cap: int):
    """Stacked [B, point_cap] arrays of the frames, zero / 255 padded."""
    b = len(paths)
    xyz = np.zeros((b, point_cap, 3), np.float32)
    sig = np.zeros((b, point_cap), np.float32)
    valid = np.zeros((b, point_cap), bool)
    labels = np.full((b, point_cap), IGNORE, np.int32)
    for i, p in enumerate(paths):
        x, s, lab = read_frame(p)
        n = min(len(x), point_cap)
        xyz[i, :n], sig[i, :n], valid[i, :n], labels[i, :n] = x[:n], s[:n], True, lab[:n]
    return xyz, sig, valid, labels


class Draws(NamedTuple):
    affine: torch.Tensor  # [b, 3, 3]
    r1: torch.Tensor  # [b, 1, 3]
    r2: torch.Tensor


def draw_augment(gen: torch.Generator, b: int) -> Draws:
    """The draws in the program's order: N(0,1) [b,3,3], flips, angles, r1, r2."""
    trans = torch.eye(3) + torch.randn((b, 3, 3), generator=gen) * 0.1
    flip = torch.randint(0, 2, (b,), generator=gen) * 2 - 1
    trans[:, 0, 0] *= flip.to(trans.dtype)
    theta = torch.rand((b,), generator=gen) * 2.0 * math.pi
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, s, z], -1), torch.stack([-s, c, z], -1), torch.stack([z, z, o], -1)], 1)
    r1 = torch.rand((b, 1, 3), generator=gen)
    r2 = torch.rand((b, 1, 3), generator=gen)
    return Draws(trans @ rot, r1, r2)


def voxel_coords(xyz: torch.Tensor, valid: torch.Tensor, d: Draws, scale: float, full_scale: int):
    """[B, P, 3] augmented point xyz and int voxel coords, and the in-grid mask."""
    dev = xyz.device
    xa = xyz @ d.affine.to(dev)
    c = xa * scale
    cmin = torch.where(valid[..., None], c, 1e30).amin(dim=1, keepdim=True)
    cmax = torch.where(valid[..., None], c, -1e30).amax(dim=1, keepdim=True)
    span = float(full_scale) - (cmax - cmin)
    c = c + (-cmin + torch.clamp_min(span - 0.001, 0.0) * d.r1.to(dev) + torch.clamp_max(span + 0.001, 0.0) * d.r2.to(dev))
    ok = valid & (c.amin(-1) >= 0) & (c.amax(-1) < full_scale)
    return xa, torch.where(ok[..., None], c, 0.0).to(torch.int32), ok


_SH = 1 << 16  # key radix: coords + 1 lie in [0, 2**14] at every level


def pack(c: torch.Tensor) -> torch.Tensor:
    c = c.long() + 1
    return (c[..., 0] * _SH + c[..., 1]) * _SH + c[..., 2]


class Level(NamedTuple):
    """One frame's level: sorted unique voxels (the first ``cap`` kept)."""

    coords: torch.Tensor  # [n, 3] int64
    nbr: torch.Tensor  # [n, 27] rows of coords + offset (x-major taps), -1 where absent


class Frame(NamedTuple):
    levels: List[Level]
    parent: List[torch.Tensor]  # parent[l]: [n_l] row at level l + 1, -1 where dropped
    first: torch.Tensor  # [n_0] the point index each level-0 voxel keeps
    overflow: List[int]  # voxels dropped per level
    inverse: torch.Tensor  # [p] each input point's level-0 row, -1 where its voxel was dropped


OFFSETS3 = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)])


def _lookup(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if keys.numel() == 0:
        return torch.full_like(q, -1)
    pos = torch.searchsorted(keys, q).clamp_max(keys.numel() - 1)
    return torch.where(keys[pos] == q, pos, -1)


def _level(coords: torch.Tensor) -> Level:
    keys = pack(coords)
    q = pack(coords[:, None, :] + OFFSETS3.to(coords.device)[None])
    return Level(coords, _lookup(keys, q))


def build_frame(coords0: torch.Tensor, caps: Sequence[int]) -> Frame:
    """coords0 [p, 3] int voxel coords of one frame's valid points."""
    keys, inv = torch.unique(pack(coords0), sorted=True, return_inverse=True)
    idx = torch.arange(len(inv), device=inv.device)
    first = torch.full((len(keys),), len(inv), dtype=torch.long, device=inv.device).scatter_reduce(0, inv, idx, "amin")
    overflow = [max(0, len(keys) - caps[0])]
    first = first[: caps[0]]
    cur = coords0[first].long()
    levels, parents = [_level(cur)], []
    for cap in caps[1:]:
        ck, cinv = torch.unique(pack(cur >> 1), sorted=True, return_inverse=True)
        overflow.append(max(0, len(ck) - cap))
        parents.append(torch.where(cinv < cap, cinv, -1))
        rep = torch.full((len(ck),), len(cinv), dtype=torch.long, device=cinv.device)
        rep = rep.scatter_reduce(0, cinv, torch.arange(len(cinv), device=cinv.device), "amin")[:cap]
        cur = cur[rep] >> 1
        levels.append(_level(cur))
    return Frame(levels, parents, first, overflow, torch.where(inv < caps[0], inv, -1))


def level_counts(fr: Frame):
    """(valid voxels, real kernel-3 pairs, real down pairs) per level."""
    rows = [len(lv.coords) for lv in fr.levels]
    subm = [int((lv.nbr >= 0).sum()) for lv in fr.levels]
    down = [int((p >= 0).sum()) for p in fr.parent]
    return rows, subm, down
