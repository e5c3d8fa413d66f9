"""VCCS supervoxel preparation pipeline (the ReDAL partition; port of
``lidal_tpu/prep/supervoxel_vccs.py``).

Reference parity: ``dataset/prepare_supervoxel_VCCS_sk.py`` — per frame run VCCS
(our native C++ implementation instead of the PCL binary + PCD round trip),
then keep only supervoxels with label != 0 and > 100 points
(``:71-77``), assign globally-unique ids, and write per-frame sv_info plus the
global id2sv index.
"""

from __future__ import annotations

import os

import numpy as np

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.data.selection import frame_name, save_sv_info
from lidal_tpu_torch.prep.native import vccs_cluster
from lidal_tpu_torch.runtime.paths import Paths, ensure_dir

MIN_POINTS = 100  # reference prepare_supervoxel_VCCS_sk.py:75


def vccs_frame_info(sv_label: np.ndarray, min_points: int = MIN_POINTS):
    """Raw per-point VCCS labels -> (point2sv [n] int32 with -1 for pruned,
    n_kept) keeping label != 0 supervoxels with > min_points points, renumbered
    densely in ascending original-label order (reference :70-77)."""
    point2sv = np.full(len(sv_label), -1, np.int32)
    kept = 0
    for sv_l in np.unique(sv_label):
        if sv_l == 0:
            continue
        p_ids = np.where(sv_label == sv_l)[0]
        if len(p_ids) > min_points:
            point2sv[p_ids] = kept
            kept += 1
    return point2sv, kept


def prepare_supervoxels_vccs(
    cfg: RunConfig,
    seq_frames: dict,
    read_xyz,
    voxel_res: float = 0.5,
    seed_res: float = 10.0,
    verbose: bool = False,
) -> None:
    paths = Paths(cfg)
    gid = 0
    id_seq, id_frame, id_local = [], [], []
    for seq, frames in seq_frames.items():
        out_dir = ensure_dir(paths.supervoxel_dir(seq, "VCCS"))
        for fr in frames:
            xyz = read_xyz(fr)
            sv_label = vccs_cluster(xyz, voxel_res=voxel_res, seed_res=seed_res)
            point2sv, kept = vccs_frame_info(sv_label)
            sv_gid = np.arange(gid, gid + kept, dtype=np.int64)
            name = frame_name(fr)
            save_sv_info(os.path.join(out_dir, f"{name}.npz"), point2sv, sv_gid)
            id_seq += [seq] * kept
            id_frame += [name] * kept
            id_local += list(range(kept))
            gid += kept
            if verbose:
                print(f"vccs {seq}/{name}: {kept} supervoxels")
    base = os.path.join(cfg.processing_root, cfg.dataset_name, "super_voxel", "VCCS")
    ensure_dir(base)
    np.savez_compressed(
        os.path.join(base, "id2sv.npz"),
        seq=np.array(id_seq),
        frame=np.array(id_frame),
        local=np.array(id_local, np.int64),
    )
