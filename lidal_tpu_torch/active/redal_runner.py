"""ReDAL and SV-RAND round orchestrators (reference ``score/sv_level/ReDAL.py``,
``score/sv_level/RAND.py`` mains; port of ``lidal_tpu/active/redal_runner.py``).
Host numpy from the previous round's npy dumps to the new flag files: no
device work, so no ``device`` argument."""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np

from lidal_tpu_torch.active import redal
from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.data.selection import load_sv_info
from lidal_tpu_torch.runtime.paths import Paths, ensure_dir


def _collect_prev_flags(cfg: RunConfig, split: Sequence[str]):
    """Previous-round sv flags + offsets + this round's save paths
    (ReDAL.py:125-148 / RAND.py:40-56)."""
    paths = Paths(cfg)
    flags_list: List[np.ndarray] = []
    save_paths: List[str] = []
    names_by_seq = {}
    for seq in split:
        if cfg.r_id == 1:
            fdir = paths.sv_flag_dir(seq, r_id=0)
        else:
            fdir = Paths(dataclasses.replace(cfg, r_id=cfg.r_id - 1)).sv_flag_dir(seq)
        names = sorted(f[:-4] for f in os.listdir(fdir) if f.endswith(".npy"))
        names_by_seq[seq] = names
        out_dir = ensure_dir(paths.sv_flag_dir(seq))
        for name in names:
            flags_list.append(np.load(os.path.join(fdir, f"{name}.npy")).astype(np.int64))
            save_paths.append(os.path.join(out_dir, f"{name}.npy"))
    offsets = np.cumsum([0] + [len(f) for f in flags_list])
    flags = np.concatenate(flags_list) if flags_list else np.zeros(0, np.int64)
    return flags, offsets, save_paths, names_by_seq


def _save_flags(flags: np.ndarray, offsets, save_paths) -> None:
    for i, sp in enumerate(save_paths):
        np.save(sp, flags[offsets[i] : offsets[i + 1]])


def run_redal_round(
    cfg: RunConfig,
    train_split: Sequence[str] | None = None,
    train_point_num: int | None = None,
    verbose: bool = False,
) -> redal.ReDALSelection:
    """One ReDAL scoring + diversity-selection round (VCCS partition)."""
    assert cfg.r_id >= 1 and cfg.metric_name == "ReDAL"
    data = cfg.data
    split = list(train_split or data.train_split)
    tpn = train_point_num or data.train_point_num
    paths = Paths(cfg)

    flags, offsets, save_paths, names_by_seq = _collect_prev_flags(cfg, split)
    n_total = len(flags)
    sv_scores = np.zeros(n_total, np.float32)
    sv_feats = np.zeros((n_total, redal.FT_DIM), np.float32)
    stats_dir = os.path.join(cfg.processing_root, cfg.dataset_name, "super_voxel", "VCCS")
    pnums_path = os.path.join(stats_dir, "sv_pnums.npy")
    sv_pre = os.path.exists(pnums_path)
    sv_pnums = np.load(pnums_path) if sv_pre else np.zeros(n_total, np.int64)

    for seq in split:
        if cfg.r_id == 1:
            prev = dataclasses.replace(cfg, r_id=0, label_unit="fr")
        else:
            prev = dataclasses.replace(cfg, r_id=cfg.r_id - 1)
        pp = Paths(prev)
        prob_dir, feat_dir = pp.prob_dir(seq), pp.outfeat_dir(seq)
        bdir = paths.boundary_dir(seq)
        svi_dir = paths.supervoxel_dir(seq, "VCCS")
        for name in names_by_seq[seq]:
            prob = np.load(os.path.join(prob_dir, f"{name}.npy"))
            outfeat = np.load(os.path.join(feat_dir, f"{name}.npy"))
            curvature = np.load(os.path.join(bdir, f"{name}.npy"))
            point2sv, sv_gid = load_sv_info(os.path.join(svi_dir, f"{name}.npz"))
            score = redal.point_information_score(prob, curvature)
            s, f, cnt = redal.sv_scores_and_feats(score, outfeat, point2sv, len(sv_gid))
            sv_scores[sv_gid] = s
            sv_feats[sv_gid] = f
            if not sv_pre:
                sv_pnums[sv_gid] = cnt
            if verbose:
                print(f"ReDAL {seq}/{name}")

    if not sv_pre:
        ensure_dir(stats_dir)
        np.save(pnums_path, sv_pnums)

    result = redal.select(flags, sv_scores, sv_feats, sv_pnums, tpn)
    _save_flags(result.sv_flags, offsets, save_paths)
    return result


def run_sv_rand_round(
    cfg: RunConfig,
    train_split: Sequence[str] | None = None,
    train_point_num: int | None = None,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """SV-level RAND round (KMeans partition, reference sv_level/RAND.py)."""
    assert cfg.r_id >= 1 and cfg.metric_name == "RAND"
    data = cfg.data
    split = list(train_split or data.train_split)
    tpn = train_point_num or data.train_point_num
    flags, offsets, save_paths, names_by_seq = _collect_prev_flags(cfg, split)

    # point counts per sv from the partition files
    sv_pnums = np.zeros(len(flags), np.int64)
    paths = Paths(cfg)
    for seq in split:
        svi_dir = paths.supervoxel_dir(seq, "KMeans")
        for name in names_by_seq[seq]:
            point2sv, sv_gid = load_sv_info(os.path.join(svi_dir, f"{name}.npz"))
            m = point2sv >= 0
            sv_pnums[sv_gid] = np.bincount(point2sv[m], minlength=len(sv_gid))

    new_flags = redal.select_random_svs(flags, sv_pnums, tpn, rng=rng)
    _save_flags(new_flags, offsets, save_paths)
    return new_flags
