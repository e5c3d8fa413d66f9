"""Artifact path taxonomy — the filesystem IS the inter-stage bus (the port's
own copy of ``lidal_tpu/runtime/paths.py``; both give the same strings).

Mirrors the reference's ``check_points``/``Processing_files`` trees exactly
(reference ``train.py:170-195``, ``score/prob_inference.py:143-217``,
``score/sv_level/LiDAL.py:141-167``, ``dataset/sk_dataloader.py:85-129``) so a
user of the reference finds artifacts in the same places.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from lidal_tpu_torch.config import RunConfig


@dataclass(frozen=True)
class Paths:
    cfg: RunConfig

    @property
    def metric(self) -> str:
        """Artifact-namespace metric: the '_pseudo' suffix selects a training
        behavior (pseudo-label injection), not a different artifact tree.  The
        reference leaves this dangling (its LiDAL selector writes flags under
        'LiDAL' while a 'LiDAL_pseudo' run would read 'LiDAL_pseudo' — SURVEY
        quirk 5); here both variants share one namespace.
        """
        m = self.cfg.metric_name
        return m[:-7] if m.endswith("_pseudo") else m

    # ----- check_points ---------------------------------------------------------

    def ckpt_dir(self, r_id: int | None = None) -> str:
        """check_points/{DS}/{model}/(0r | full | {unit}/{metric}/{r}r) (train.py:178-195)."""
        c = self.cfg
        r = c.r_id if r_id is None else r_id
        base = os.path.join(c.checkpoint_root, c.dataset_name, c.model_name)
        if r == 0:
            return os.path.join(base, "0r")
        if c.metric_name == "full":
            return os.path.join(base, "full")
        return os.path.join(base, c.label_unit, self.metric, f"{r}r")

    def warm_start_ckpt_dir(self) -> str:
        """Previous round's weights (train.py:73-85): round 1 starts from 0r."""
        c = self.cfg
        assert c.r_id > 0
        if c.r_id == 1:
            return os.path.join(c.checkpoint_root, c.dataset_name, c.model_name, "0r")
        return self.ckpt_dir(c.r_id - 1)

    # ----- Processing_files -----------------------------------------------------

    def _artifact_dir(self, kind: str, r_id: int | None = None) -> str:
        """Processing_files/{DS}/{kind}/{model}/{unit}/(0r | {metric}/{r}r)
        (prob_inference.py:143-217)."""
        c = self.cfg
        r = c.r_id if r_id is None else r_id
        base = os.path.join(c.processing_root, c.dataset_name, kind, c.model_name, c.label_unit)
        if r == 0:
            return os.path.join(base, "0r")
        return os.path.join(base, self.metric, f"{r}r")

    def prob_dir(self, seq: str, r_id: int | None = None) -> str:
        return os.path.join(self._artifact_dir("prob_map", r_id), seq)

    def pred_dir(self, seq: str, r_id: int | None = None) -> str:
        return os.path.join(self._artifact_dir("pred", r_id), seq)

    def outfeat_dir(self, seq: str, r_id: int | None = None) -> str:
        return os.path.join(self._artifact_dir("outfeat", r_id), seq)

    def frame_flag_dir(self, r_id: int | None = None, metric: str | None = None) -> str:
        """Processing_files/{DS}/frame_flag/(0r | RAND/{r}r | {model}/{metric}/{r}r)."""
        c = self.cfg
        r = c.r_id if r_id is None else r_id
        m = (self.metric if metric is None else metric)
        base = os.path.join(c.processing_root, c.dataset_name, "frame_flag")
        if r == 0:
            return os.path.join(base, "0r")
        if m == "RAND":
            return os.path.join(base, "RAND", f"{r}r")
        return os.path.join(base, c.model_name, m, f"{r}r")

    def sv_flag_dir(self, seq: str, r_id: int | None = None, metric: str | None = None) -> str:
        """Processing_files/{DS}/sv_flag/{partition}/(0r|RAND/{r}r|{model}/{metric}/{r}r)/{seq}
        (LiDAL.py:141-158, ReDAL uses VCCS, everything else KMeans)."""
        c = self.cfg
        r = c.r_id if r_id is None else r_id
        m = (self.metric if metric is None else metric)
        part = "VCCS" if m == "ReDAL" else "KMeans"
        base = os.path.join(c.processing_root, c.dataset_name, "sv_flag", part)
        if r == 0:
            return os.path.join(base, "0r", seq)
        if m == "RAND":
            return os.path.join(base, "RAND", f"{r}r", seq)
        return os.path.join(base, c.model_name, m, f"{r}r", seq)

    def supervoxel_dir(self, seq: str, partition: str = "KMeans") -> str:
        return os.path.join(self.cfg.processing_root, self.cfg.dataset_name, "super_voxel", partition, seq)

    def grid_dir(self, seq: str) -> str:
        """Pose-registered per-frame point tables (the reference's kdtree pickles,
        prepare_kdtree_sk.py:83-88 — here hash-grid-ready npz)."""
        return os.path.join(self.cfg.processing_root, self.cfg.dataset_name, "grid", seq)

    def boundary_dir(self, seq: str) -> str:
        """ReDAL surface-variation ('boundary') npy files (gen_surface_variation_sk.py)."""
        return os.path.join(self.cfg.processing_root, self.cfg.dataset_name, "boundary", seq)


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
