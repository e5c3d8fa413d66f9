"""Label-set bookkeeping: frame/supervoxel flags, round-0 bootstrap, sv masking
(port of ``lidal_tpu/data/selection.py``, numpy only).

Reference parity:
* round-0 bootstrap — random 1% fully-labeled frames + per-frame sv_flag trees
  (``dataset/sk_dataloader.py:81-147``).  The reference samples with
  ``np.random.choice`` WITH replacement (quirk: can select < 1% unique frames,
  SURVEY.md quirk 3) — reproduced faithfully.
* frame-level training set — flags concatenated over sequences
  (``sk_dataloader.py:151-180``).
* sv-level training set — frames with >= 1 labeled supervoxel; per-point label
  masking with flag==1 keeping annotation and flag==2 injecting pseudo labels
  (``sk_dataset.py:122-141``, ``sk_dataloader.py:239-297``).

Supervoxel info format (ours): per-frame ``.npz`` with
  ``point2sv``: [N] int32 frame-local supervoxel index per point (-1 = none),
  ``sv_gid``:   [n_sv] int64 globally-unique supervoxel ids,
replacing the reference's ``(sv_id, sv2point)`` pickles.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from lidal_tpu.config import RunConfig
from lidal_tpu.runtime.paths import Paths, ensure_dir
from lidal_tpu_torch.data.pipeline import IGNORE_LABEL


def frame_name(fr) -> str:
    """Canonical frame name: SK velodyne path -> basename without extension;
    nuScenes manifest entry (dict) -> its sample_data token."""
    if isinstance(fr, dict):
        return fr["token"]
    return os.path.basename(fr)[:-4]


def load_sv_info(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (point2sv [N] int32, sv_gid [n_sv] int64)."""
    with np.load(path) as z:
        return z["point2sv"].astype(np.int32), z["sv_gid"].astype(np.int64)


def save_sv_info(path: str, point2sv: np.ndarray, sv_gid: np.ndarray) -> None:
    np.savez_compressed(path, point2sv=point2sv.astype(np.int32), sv_gid=sv_gid.astype(np.int64))


def bootstrap_round0(
    cfg: RunConfig,
    seq_frames: dict,  # seq -> list of frame paths
    sv_partitions: Sequence[str] = ("KMeans", "VCCS"),
    rng: Optional[np.random.Generator] = None,
) -> None:
    """Write round-0 frame_flag + sv_flag trees if absent (sk_dataloader.py:85-129)."""
    paths = Paths(cfg)
    rng = rng or np.random.default_rng(0)
    ff_dir = paths.frame_flag_dir(r_id=0)
    if os.path.exists(ff_dir) and glob.glob(os.path.join(ff_dir, "*.npy")):
        return
    ensure_dir(ff_dir)
    for seq, frames in seq_frames.items():
        n = len(frames)
        flag = np.zeros(n, bool)
        # With replacement, like the reference (sk_dataloader.py:103).
        sel = rng.choice(np.arange(n), int(np.round(0.01 * n)))
        flag[sel] = True
        np.save(os.path.join(ff_dir, f"{seq}.npy"), flag)
        for part in sv_partitions:
            sv_dir = os.path.join(
                cfg.processing_root, cfg.dataset_name, "sv_flag", part, "0r", seq
            )
            ensure_dir(sv_dir)
            svi_dir = paths.supervoxel_dir(seq, part)
            for idx, fr in enumerate(frames):
                name = frame_name(fr)
                svi_path = os.path.join(svi_dir, f"{name}.npz")
                if not os.path.exists(svi_path):
                    continue
                _, sv_gid = load_sv_info(svi_path)
                sv_flag = np.full(len(sv_gid), bool(flag[idx]), dtype=np.int32)
                np.save(os.path.join(sv_dir, f"{name}.npy"), sv_flag)


def frame_flags_for_round(cfg: RunConfig, seqs: Sequence[str]) -> np.ndarray:
    """Concatenated frame flags of the *current* round (sk_dataloader.py:160-171)."""
    paths = Paths(cfg)
    out = []
    for seq in seqs:
        if cfg.r_id == 0:
            f = np.load(os.path.join(paths.frame_flag_dir(r_id=0), f"{seq}.npy"))
        else:
            f = np.load(os.path.join(paths.frame_flag_dir(), f"{seq}.npy"))
        out.append(f.astype(bool))
    return np.concatenate(out) if out else np.zeros(0, bool)


def train_files_frame_level(cfg: RunConfig, all_files: List[str], seqs: Sequence[str]) -> List[str]:
    flags = frame_flags_for_round(cfg, seqs)
    assert len(flags) == len(all_files), (len(flags), len(all_files))
    return [f for f, keep in zip(all_files, flags) if keep]


def sv_training_set(
    cfg: RunConfig, seq_frames: dict
) -> Tuple[List[str], List[str], List[str], Optional[List[str]]]:
    """Frames with >= 1 labeled SV, plus their sv_flag / sv_info / pseudo paths
    (sk_dataloader.py:256-291)."""
    paths = Paths(cfg)
    part = "VCCS" if cfg.metric_name == "ReDAL" else "KMeans"
    with_pseudo = "pseudo" in cfg.metric_name
    lidar, svf, svi, pse = [], [], [], ([] if with_pseudo else None)
    for seq, frames in seq_frames.items():
        flag_dir = paths.sv_flag_dir(seq)
        svi_dir = paths.supervoxel_dir(seq, part)
        if with_pseudo:
            # pseudo labels come from the previous round's pred dump
            # (sk_dataloader.py:272-277)
            if cfg.r_id == 1:
                prev = dataclasses.replace(cfg, r_id=0, label_unit="fr")
            else:
                prev = dataclasses.replace(cfg, r_id=cfg.r_id - 1)
            pred_dir = Paths(prev).pred_dir(seq)
        for fr in frames:
            name = frame_name(fr)
            fpath = os.path.join(flag_dir, f"{name}.npy")
            if not os.path.exists(fpath):
                continue
            flags = np.load(fpath)
            if (np.asarray(flags) != 0).sum() == 0:
                continue
            lidar.append(fr)
            svf.append(fpath)
            svi.append(os.path.join(svi_dir, f"{name}.npz"))
            if with_pseudo:
                pse.append(os.path.join(pred_dir, f"{name}.npy"))
    return lidar, svf, svi, pse


def apply_sv_label_mask(
    labels: np.ndarray,  # [N] int32 annotated (remapped) labels
    point2sv: np.ndarray,  # [N] int32 frame-local sv index (-1 = none)
    sv_flag: np.ndarray,  # [n_sv] int (0 unlabeled / 1 human / 2 pseudo)
    pseudo_labels: Optional[np.ndarray] = None,  # [N] int32
) -> np.ndarray:
    """Per-point training labels under supervoxel flags (sk_dataset.py:122-141)."""
    sv_flag = np.asarray(sv_flag).astype(np.int64)
    flag_ext = np.concatenate([sv_flag, [0]])  # point2sv == -1 -> flag 0
    pf = flag_ext[point2sv]
    out = np.where(pf == 1, labels, IGNORE_LABEL).astype(np.int32)
    if pseudo_labels is not None:
        assert pseudo_labels.shape[0] == labels.shape[0]
        out = np.where(pf == 2, pseudo_labels.astype(np.int32), out)
    return out
