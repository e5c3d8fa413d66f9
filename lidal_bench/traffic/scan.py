"""Scan-like SemanticKITTI frames: a spinning 64-beam LiDAR (modelled on the
HDL-64E of SemanticKITTI) ray-cast against a seeded street, on the device.

The sensor sits ``mount_height`` above the ground; ``beams`` rows spread
evenly from ``elev_top_deg`` down to ``elev_bottom_deg``, ``azimuths``
columns a turn.  The scene is analytic: the ground plane (road, sidewalk,
terrain by the lateral distance), boxes (buildings, parked cars, fences,
signs), vertical cylinders (poles, trunks, people) and ellipsoids
(tree crowns).  Each ray returns its nearest hit within ``max_range``,
with Gaussian range noise and seeded drop-outs; labels are the raw
SemanticKITTI ids of what was hit, intensity a per-class reflectance times
the cosine of the incidence angle.  The ego drives along +x by ``step_m`` a
frame with a small seeded yaw drift, so consecutive frames overlap as in a
sequence, and point density falls with range, so coarse voxel levels thin
out as in scans.

The same seeds give the same frames.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, NamedTuple

import numpy as np
import torch

# raw SemanticKITTI ids (all of the 19 train classes' raw ids used here)
ROAD, PARKING, SIDEWALK, TERRAIN = 40, 44, 48, 72
BUILDING, FENCE, CAR, TRUCK, OTHER_VEHICLE = 50, 51, 10, 18, 20
POLE, SIGN, TRUNK, VEGETATION = 80, 81, 71, 70
PERSON, BICYCLE, BICYCLIST, MOTORCYCLE, MOTORCYCLIST, OTHER_GROUND = 30, 11, 31, 15, 32, 49

REFLECTANCE = {ROAD: 0.25, PARKING: 0.3, SIDEWALK: 0.35, TERRAIN: 0.3, OTHER_GROUND: 0.3, BUILDING: 0.45,
               FENCE: 0.4, CAR: 0.6, TRUCK: 0.55, OTHER_VEHICLE: 0.5, POLE: 0.5, SIGN: 0.9, TRUNK: 0.35,
               VEGETATION: 0.4, PERSON: 0.3, BICYCLE: 0.45, BICYCLIST: 0.35, MOTORCYCLE: 0.5, MOTORCYCLIST: 0.35}


class Scene(NamedTuple):
    boxes: torch.Tensor  # [nb, 6] min xyz, max xyz
    box_label: torch.Tensor  # [nb] raw ids
    cyl: torch.Tensor  # [nc, 5] cx, cy, radius, z0, z1
    cyl_label: torch.Tensor
    ell: torch.Tensor  # [ne, 6] centre xyz, semi-axes
    ell_label: torch.Tensor


def _uniform(g: np.random.Generator, lo, hi, n=None):
    return g.uniform(lo, hi, n)


def make_scene(seed: int, length_m: float, p: Dict) -> Scene:
    """A street along x in ``[-90, length_m + 90]``: road ``|y| < road_half``,
    sidewalks, terrain; on each side façades, parked cars, poles with signs,
    trees, fences and a few people and two-wheelers."""
    g = np.random.default_rng([seed, 1])
    x0, x1 = -90.0, length_m + 90.0
    boxes, blab, cyls, clab, ells, elab = [], [], [], [], [], []
    rh, sw = p["road_half_m"], p["sidewalk_m"]
    for side in (-1.0, 1.0):
        # façades: buildings of 8-25 m frontage with gaps, set back 2-6 m behind the sidewalk
        x = x0
        while x < x1:
            w = _uniform(g, 8, 25)
            if g.random() < 0.8:
                back = rh + sw + _uniform(g, 2, 6)
                depth, h = _uniform(g, 8, 15), _uniform(g, 6, 20)
                ys = sorted([side * back, side * (back + depth)])
                boxes.append([x, ys[0], 0.0, x + w, ys[1], h])
                blab.append(BUILDING)
            elif g.random() < 0.7:  # a fence across the gap
                y = side * (rh + sw + _uniform(g, 0.5, 2))
                boxes.append([x, y - 0.05, 0.0, x + w, y + 0.05, _uniform(g, 1.0, 2.0)])
                blab.append(FENCE)
            x += w + _uniform(g, 0.5, 6)
        # parked cars along the kerb
        x = x0
        while x < x1:
            kind = g.choice([CAR, CAR, CAR, CAR, TRUCK, OTHER_VEHICLE])
            ln, wd, ht = {CAR: (4.4, 1.8, 1.5), TRUCK: (7.5, 2.4, 3.0), OTHER_VEHICLE: (5.5, 2.1, 2.4)}[int(kind)]
            yc = side * (rh - wd / 2 - 0.2)
            if g.random() < 0.7:
                boxes.append([x, yc - wd / 2, 0.15, x + ln, yc + wd / 2, ht])
                blab.append(int(kind))
            x += ln + _uniform(g, 1.0, 8.0)
        # poles with a sign, every 15-30 m on the sidewalk
        x = x0 + _uniform(g, 0, 15)
        while x < x1:
            y = side * (rh + 0.5)
            cyls.append([x, y, 0.08, 0.0, 6.0])
            clab.append(POLE)
            if g.random() < 0.5:
                boxes.append([x - 0.4, y - 0.03, 2.2, x + 0.4, y + 0.03, 2.9])
                blab.append(SIGN)
            x += _uniform(g, 15, 30)
        # trees: trunk + crown, every 7-14 m between sidewalk and façade
        x = x0 + _uniform(g, 0, 7)
        while x < x1:
            y = side * (rh + sw - 0.8)
            r = _uniform(g, 1.5, 3.0)
            cyls.append([x, y, _uniform(g, 0.12, 0.25), 0.0, 2.5])
            clab.append(TRUNK)
            ells.append([x, y, 2.5 + r, r, r, _uniform(g, 1.2, 2.5)])
            elab.append(VEGETATION)
            x += _uniform(g, 7, 14)
        # people and two-wheelers on the sidewalk
        for _ in range(int(length_m / 15) + 8):
            kind = int(g.choice([PERSON, PERSON, BICYCLE, MOTORCYCLE, BICYCLIST, MOTORCYCLIST]))
            x = _uniform(g, x0, x1)
            y = side * _uniform(g, rh + 0.5, rh + sw - 0.3)
            if kind == PERSON:
                cyls.append([x, y, 0.25, 0.0, _uniform(g, 1.6, 1.9)])
                clab.append(PERSON)
            else:
                boxes.append([x, y - 0.3, 0.0, x + 1.8, y + 0.3, 1.1 if kind in (BICYCLE, MOTORCYCLE) else 1.7])
                blab.append(kind)
    # a few parking bays and patches of other ground
    for _ in range(4):
        x = _uniform(g, x0, x1)
        side = 1.0 if g.random() < 0.5 else -1.0
        ys = sorted([side * (rh + sw), side * (rh + sw + 6)])
        boxes.append([x, ys[0], -0.5, x + 15, ys[1], 0.02])
        blab.append(PARKING if g.random() < 0.5 else OTHER_GROUND)
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt)  # noqa: E731
    return Scene(t(boxes).reshape(-1, 6), t(blab, torch.int32), t(cyls).reshape(-1, 5), t(clab, torch.int32),
                 t(ells).reshape(-1, 6), t(elab, torch.int32))


def poses(n_frames: int, seed: int, p: Dict) -> np.ndarray:
    """[n, 4, 4] sensor poses in the world: x += step a frame, yaw drifting."""
    g = np.random.default_rng([seed, 2])
    yaw = np.cumsum(g.normal(0.0, math.radians(p["yaw_drift_deg"]), n_frames))
    out = np.tile(np.eye(4), (n_frames, 1, 1))
    x = y = 0.0
    for i in range(n_frames):
        if i:
            x += p["step_m"] * math.cos(yaw[i])
            y += p["step_m"] * math.sin(yaw[i])
        c, s = math.cos(yaw[i]), math.sin(yaw[i])
        out[i, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        out[i, :3, 3] = [x, y, p["mount_height_m"]]
    return out


def _ray_dirs(p: Dict, device) -> torch.Tensor:
    el = torch.linspace(math.radians(p["elev_top_deg"]), math.radians(p["elev_bottom_deg"]), p["beams"],
                        dtype=torch.float64, device=device)
    az = torch.arange(p["azimuths"], dtype=torch.float64, device=device) * (2 * math.pi / p["azimuths"])
    el, az = torch.meshgrid(el, az, indexing="ij")
    return torch.stack([el.cos() * az.cos(), el.cos() * az.sin(), el.sin()], -1).reshape(-1, 3)


def _hit_boxes(o, d, boxes):
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t0 = (boxes[None, :, :3] - o[:, None]) * inv[:, None]
    t1 = (boxes[None, :, 3:] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    ok = (tf >= tn) & (tn > 1e-3)
    t = torch.where(ok, tn, math.inf)
    tbest, ib = t.min(1)
    # normal: the axis whose entry plane was hit last
    axis = torch.minimum(t0, t1).gather(1, ib[:, None, None].expand(-1, 1, 3))[:, 0].argmax(-1)
    n = torch.nn.functional.one_hot(axis, 3).to(o.dtype)
    return tbest, ib, n


def _hit_cyl(o, d, cyl):
    ox = o[:, None, 0] - cyl[None, :, 0]
    oy = o[:, None, 1] - cyl[None, :, 1]
    a = (d[:, 0] ** 2 + d[:, 1] ** 2)[:, None].clamp_min(1e-12)
    b = 2 * (ox * d[:, None, 0] + oy * d[:, None, 1])
    c = ox ** 2 + oy ** 2 - cyl[None, :, 2] ** 2
    disc = b * b - 4 * a * c
    t = (-b - disc.clamp_min(0).sqrt()) / (2 * a)
    z = o[:, None, 2] + t * d[:, None, 2]
    ok = (disc >= 0) & (t > 1e-3) & (z >= cyl[None, :, 3]) & (z <= cyl[None, :, 4])
    t = torch.where(ok, t, math.inf)
    tbest, ib = t.min(1)
    hit = o + tbest.clamp_max(1e6)[:, None] * d
    n = hit - torch.nn.functional.pad(cyl[ib, :2], (0, 1))
    n[:, 2] = 0
    return tbest, ib, n


def _hit_ell(o, d, ell):
    c, r = ell[None, :, :3], ell[None, :, 3:]
    oc = (o[:, None] - c) / r
    dd = d[:, None] / r
    a = (dd * dd).sum(-1)
    b = 2 * (oc * dd).sum(-1)
    cc = (oc * oc).sum(-1) - 1
    disc = b * b - 4 * a * cc
    t = (-b - disc.clamp_min(0).sqrt()) / (2 * a)
    ok = (disc >= 0) & (t > 1e-3)
    t = torch.where(ok, t, math.inf)
    tbest, ib = t.min(1)
    hit = o + tbest.clamp_max(1e6)[:, None] * d
    n = (hit - ell[ib, :3]) / ell[ib, 3:] ** 2
    return tbest, ib, n


def cast_frame(scene: Scene, pose: np.ndarray, gen: torch.Generator, p: Dict, device):
    """One frame in the sensor's coordinates: xyz [n, 3] f32, intensity [n] f32,
    raw labels [n] uint32."""
    rot = torch.tensor(pose[:3, :3], dtype=torch.float64, device=device)
    dirs_s = _ray_dirs(p, device)
    d = dirs_s @ rot.T
    o = torch.tensor(pose[:3, 3], dtype=torch.float64, device=device).expand_as(d)
    sc = Scene(*(t.to(device) for t in scene))
    # the ground
    tg = torch.where(d[:, 2] < -1e-9, -o[:, 2] / d[:, 2].clamp_max(-1e-9), torch.full_like(d[:, 2], math.inf))
    best = tg
    gy = (o[:, 1] + tg.clamp_max(1e6) * d[:, 1]).abs()
    rh, sw = p["road_half_m"], p["sidewalk_m"]
    label = torch.where(gy < rh, ROAD, torch.where(gy < rh + sw, SIDEWALK, TERRAIN)).to(torch.int32)
    normal = torch.zeros_like(d)
    normal[:, 2] = 1.0
    chunk = p.get("ray_chunk", 16384)
    for start in range(0, d.shape[0], chunk):
        sl = slice(start, start + chunk)
        for fn, prims, labs in ((_hit_boxes, sc.boxes, sc.box_label), (_hit_cyl, sc.cyl, sc.cyl_label),
                                (_hit_ell, sc.ell, sc.ell_label)):
            if prims.shape[0] == 0:
                continue
            t, ib, n = fn(o[sl], d[sl], prims.to(torch.float64))
            closer = t < best[sl]
            best[sl] = torch.where(closer, t, best[sl])
            label[sl] = torch.where(closer, labs[ib], label[sl])
            normal[sl] = torch.where(closer[:, None], n, normal[sl])
    rng = best + p["range_noise_m"] * torch.randn(best.shape, generator=gen, device=device, dtype=torch.float64)
    keep = (best < p["max_range_m"]) & (torch.rand(best.shape, generator=gen, device=device) >= p["dropout"])
    cosang = ((normal * d).sum(-1).abs() / normal.norm(dim=-1).clamp_min(1e-12)).clamp(0, 1)
    refl = torch.zeros(260, dtype=torch.float64, device=device)
    for k, v in REFLECTANCE.items():
        refl[k] = v
    inten = (refl[label.long()] * (0.3 + 0.7 * cosang)
             + 0.03 * torch.randn(best.shape, generator=gen, device=device, dtype=torch.float64)).clamp(0, 0.99)
    xyz = dirs_s * rng[:, None]
    return (xyz[keep].float().cpu().numpy(), inten[keep].float().cpu().numpy(),
            label[keep].cpu().numpy().astype(np.uint32))


def generate(seed: int, n_frames: int, p: Dict, device) -> List:
    """``n_frames`` consecutive frames and their poses.  The street and the
    ego's path come from ``p["scene_seed"]``, the same for every run of a
    traffic mix, so runs do the same work; ``seed`` draws the sensor's range
    noise, drop-outs and intensity noise."""
    ps = poses(n_frames, p["scene_seed"], p)
    scene = make_scene(p["scene_seed"], p["step_m"] * n_frames, p)
    gen = torch.Generator(device=device).manual_seed(int(np.random.SeedSequence([seed, 3]).generate_state(1)[0]))
    return [cast_frame(scene, ps[i], gen, p, device) for i in range(n_frames)], ps


def write_sequence(root: str, seq: str, frames, ps: np.ndarray) -> str:
    """SemanticKITTI layout under ``root``: ``<seq>/velodyne/*.bin``,
    ``labels/*.label``, ``poses.txt`` (identity ``Tr`` in ``calib.txt``, so
    the poses are the sensor's).  Returns the ``sequences`` root."""
    base = os.path.join(root, seq)
    os.makedirs(os.path.join(base, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(base, "labels"), exist_ok=True)
    for i, (xyz, sig, lab) in enumerate(frames):
        np.concatenate([xyz, sig[:, None]], 1).astype(np.float32).tofile(os.path.join(base, "velodyne", f"{i:06d}.bin"))
        lab.astype(np.uint32).tofile(os.path.join(base, "labels", f"{i:06d}.label"))
    with open(os.path.join(base, "poses.txt"), "w") as f:
        for m in ps:
            f.write(" ".join(f"{v:.9e}" for v in m[:3].reshape(-1)) + "\n")
    with open(os.path.join(base, "calib.txt"), "w") as f:
        eye = " ".join(f"{v:.9e}" for v in np.eye(4)[:3].reshape(-1))
        for k in ("P0", "P1", "P2", "P3", "Tr"):
            f.write(f"{k}: {eye}\n")
    return root
