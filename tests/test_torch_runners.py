"""Port parity: the frame-level, ReDAL and sv-RAND round orchestrators
(``lidal_tpu_torch/active/frame_runner.py``, ``active/redal_runner.py``) and the
full dispatch of ``cli/commands.score_command`` against the JAX package.

Both packages run on copies of one artifact tree laid out as the tree of
``tests/test_runners.py`` (round-0 prob / pred / outfeat dumps, frame flags,
KMeans and VCCS supervoxel infos and flags, boundary npys), with enough frames
that the 1 % budget adds one: 2 sequences x 60 frames.  Held: every flag file
the port writes equals the JAX package's (dtype too), for all eight metric /
unit pairs, in ``reference_parity`` mode, through the runners and through
``score_command``.  The device scores agree to 1e-6
(``tests/test_torch_frame_level.py``); on this tree the selected frame is the
same, and everything after the scores is numpy copied line for line."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from lidal_tpu.active.frame_runner import run_frame_metric_round as jax_run_frame_metric_round
from lidal_tpu.active.redal_runner import run_redal_round as jax_run_redal_round
from lidal_tpu.active.redal_runner import run_sv_rand_round as jax_run_sv_rand_round
from lidal_tpu.cli.commands import score_command as jax_score_command
from lidal_tpu.data.selection import save_sv_info
from lidal_tpu.runtime.paths import Paths as JaxPaths, ensure_dir
from lidal_tpu_torch.active import frame_runner, redal_runner
from lidal_tpu_torch.cli import commands
from lidal_tpu_torch.runtime.paths import Paths
from tests.synth import mini_cfg
from tests.test_torch_round import port_cfg

SEQS = ("00", "01")
N_FRAMES = 60
N_POINTS = 120
N_CLASSES = 19
N_SV = 4
TPN = 20_000  # the 1 % point budget covers a few ~30-point supervoxels

FRAME_METRICS = ["ENT", "MAR", "CONF", "SEGENT", "CSET", "RAND"]
PAIRS = [(m, "fr") for m in FRAME_METRICS] + [("ReDAL", "sv"), ("RAND", "sv")]


@pytest.fixture(scope="module")
def artifact_tree(tmp_path_factory):
    """Round-0 artifacts for 2 sequences x 60 frames."""
    root = str(tmp_path_factory.mktemp("artifacts"))
    rng = np.random.default_rng(0)
    cfg = mini_cfg(root, seqs=SEQS, r_id=1, metric_name="ENT", label_unit="fr", data_kw={"train_point_num": TPN})
    p0 = JaxPaths(dataclasses.replace(cfg, r_id=0, label_unit="fr"))
    gid = {"KMeans": 0, "VCCS": 0}
    for seq in SEQS:
        for d in (p0.prob_dir(seq), p0.pred_dir(seq), p0.outfeat_dir(seq)):
            ensure_dir(d)
        flag = np.zeros(N_FRAMES, bool)
        flag[[0, 17]] = True
        np.save(os.path.join(ensure_dir(p0.frame_flag_dir(r_id=0)), f"{seq}.npy"), flag)
        bdir = ensure_dir(p0.boundary_dir(seq))
        for fi in range(N_FRAMES):
            name = f"{fi:06d}"
            prob = rng.dirichlet(0.5 * np.ones(N_CLASSES), N_POINTS).astype(np.float32)
            np.save(os.path.join(p0.prob_dir(seq), f"{name}.npy"), prob)
            np.save(os.path.join(p0.pred_dir(seq), f"{name}.npy"), prob.argmax(1).astype(np.int32))
            np.save(os.path.join(p0.outfeat_dir(seq), f"{name}.npy"), rng.normal(size=(N_POINTS, 96)).astype(np.float32))
            np.save(os.path.join(bdir, f"{name}.npy"), rng.random(N_POINTS).astype(np.float32) * 0.1)
            for part in ("KMeans", "VCCS"):
                svf_dir = ensure_dir(os.path.join(cfg.processing_root, "SK", "sv_flag", part, "0r", seq))
                point2sv = rng.integers(-1, N_SV, N_POINTS).astype(np.int32)
                sv_gid = np.arange(gid[part], gid[part] + N_SV, dtype=np.int64)
                gid[part] += N_SV
                save_sv_info(os.path.join(ensure_dir(p0.supervoxel_dir(seq, part)), f"{name}.npz"), point2sv, sv_gid)
                np.save(os.path.join(svf_dir, f"{name}.npy"), np.full(N_SV, int(fi == 0), np.int32))
    return root, cfg


def _two_copies(artifact_tree, tmp_path, **cfg_kw):
    """(JAX config, port config), each on its own copy of the tree."""
    root, cfg = artifact_tree
    out = []
    for name in ("jax", "port"):
        dst = str(tmp_path / name)
        shutil.copytree(root, dst)
        out.append(dataclasses.replace(cfg, processing_root=os.path.join(dst, "Processing_files"), **cfg_kw))
    return out[0], port_cfg(out[1])


def _flag_files(cfg, paths_cls, metric, unit):
    p = paths_cls(cfg)
    dirs = [p.frame_flag_dir(metric=metric)] if unit == "fr" else [p.sv_flag_dir(s) for s in SEQS]
    return {(d[len(cfg.processing_root):], n): np.load(os.path.join(d, n)) for d in dirs for n in sorted(os.listdir(d))}


def _assert_same_files(jcfg, pcfg, metric, unit):
    want, got = _flag_files(jcfg, JaxPaths, metric, unit), _flag_files(pcfg, Paths, metric, unit)
    assert want.keys() == got.keys() and len(got) == (len(SEQS) if unit == "fr" else len(SEQS) * N_FRAMES)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    return got


@pytest.mark.parametrize("metric", FRAME_METRICS)
def test_frame_metric_round_flags_equal_jax(artifact_tree, tmp_path, metric):
    jcfg, pcfg = _two_copies(artifact_tree, tmp_path, metric_name=metric, label_unit="fr")
    want = jax_run_frame_metric_round(jcfg, metric, rng=np.random.default_rng(1))
    got = frame_runner.run_frame_metric_round(pcfg, metric, rng=np.random.default_rng(1), device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == bool and got.shape == (len(SEQS) * N_FRAMES,)
    assert got[[0, 17, N_FRAMES, N_FRAMES + 17]].all() and got.sum() == 4 + 1  # round(0.01 * 120) = 1 frame added
    _assert_same_files(jcfg, pcfg, metric, "fr")


def test_margin_largest_selects_the_other_end(artifact_tree, tmp_path):
    jcfg, pcfg = _two_copies(artifact_tree, tmp_path, metric_name="MAR", label_unit="fr")
    want = jax_run_frame_metric_round(jcfg, "MAR", margin_largest=True)
    got = frame_runner.run_frame_metric_round(pcfg, "MAR", margin_largest=True, device="cpu")
    np.testing.assert_array_equal(got, want)
    smallest = frame_runner.run_frame_metric_round(pcfg, "MAR", device="cpu")
    assert (got != smallest).sum() == 2


@pytest.mark.parametrize("metric", ["ENT", "MAR", "CONF", "SEGENT"])
def test_reference_parity_round_flags_equal_jax(artifact_tree, tmp_path, metric):
    jcfg, pcfg = _two_copies(artifact_tree, tmp_path, metric_name=metric, label_unit="fr", reference_parity=True)
    want = jax_run_frame_metric_round(jcfg, metric)
    got = frame_runner.run_frame_metric_round(pcfg, metric, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 4 + 1
    _assert_same_files(jcfg, pcfg, metric, "fr")


def test_redal_round_flags_equal_jax(artifact_tree, tmp_path):
    jcfg, pcfg = _two_copies(artifact_tree, tmp_path, metric_name="ReDAL", label_unit="sv")
    want = jax_run_redal_round(jcfg)
    got = redal_runner.run_redal_round(pcfg)
    np.testing.assert_array_equal(got.sv_flags, want.sv_flags)
    np.testing.assert_array_equal(got.added, want.added)
    assert len(got.added) >= 1
    _assert_same_files(jcfg, pcfg, "ReDAL", "sv")
    stats = os.path.join("SK", "super_voxel", "VCCS", "sv_pnums.npy")  # cached for the next round
    np.testing.assert_array_equal(np.load(os.path.join(pcfg.processing_root, stats)), np.load(os.path.join(jcfg.processing_root, stats)))


def test_sv_rand_round_flags_equal_jax(artifact_tree, tmp_path):
    jcfg, pcfg = _two_copies(artifact_tree, tmp_path, metric_name="RAND", label_unit="sv")
    want = jax_run_sv_rand_round(jcfg, rng=np.random.default_rng(3))
    got = redal_runner.run_sv_rand_round(pcfg, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    assert (got == 1).sum() > len(SEQS) * N_SV
    _assert_same_files(jcfg, pcfg, "RAND", "sv")


@pytest.mark.parametrize("metric,unit", PAIRS)
def test_score_command_dispatches_every_metric(artifact_tree, tmp_path, metric, unit):
    """``score_command`` raises for no metric and writes the JAX package's flags."""
    jcfg, pcfg = _two_copies(artifact_tree, tmp_path, metric_name=metric, label_unit=unit)
    jax_score_command(jcfg)
    commands.score_command(pcfg, device="cpu")
    files = _assert_same_files(jcfg, pcfg, metric, unit)
    total = sum(int((f == 1).sum()) for f in files.values())
    assert total > (4 if unit == "fr" else len(SEQS) * N_SV)  # something was added


def test_missing_score_input_fails_the_round(artifact_tree, tmp_path):
    _, pcfg = _two_copies(artifact_tree, tmp_path, metric_name="ENT", label_unit="fr")
    prev = Paths(dataclasses.replace(pcfg, r_id=0))
    os.remove(os.path.join(prev.frame_flag_dir(r_id=0), "01.npy"))
    with pytest.raises(FileNotFoundError):
        frame_runner.run_frame_metric_round(pcfg, "ENT", device="cpu")
    with pytest.raises(ValueError):
        frame_runner.run_frame_metric_round(dataclasses.replace(pcfg, r_id=1), "NOPE", train_split=("00",), device="cpu")
