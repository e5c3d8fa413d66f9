"""The LiDAL round of the port (``active/lidal_runner.py``, ``cli/commands.py``,
``runtime/round.py``) on a synthetic mini-SemanticKITTI tree, CPU.

The tree is built with ``tests/synth.make_mini_sk`` and prepared with the JAX
package's own prep (supervoxels, grids, round-0 bootstrap); its frames are
rewritten to see one static world under the poses ``make_mini_sk`` wrote, so
that registered neighbours do match.  Both packages are fed the same prob
npys.  Held: ``sv_flag`` files, selections and the supervoxel statistics
identical between the JAX package and the port (scores agree to 1e-5,
``tests/test_torch_lidal.py``; selection is numpy host code copied line for
line); in the port, the fused round's prob / pred npys, flags and selections
identical to the staged round's.  The same with ``model_name="SPVCNN"``: the
fused round equals the staged one, the JAX package scores the port's SPVCNN
prob maps to the same flags, and ``run_active_round`` chains the stages.
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from lidal_tpu.active.lidal_runner import run_lidal_round as jax_run_lidal_round
from lidal_tpu.data import semantic_kitti as jax_sk
from lidal_tpu.data.selection import bootstrap_round0 as jax_bootstrap_round0
from lidal_tpu.prep.grid import prepare_sk_grids as jax_prepare_sk_grids
from lidal_tpu.prep.supervoxel_kmeans import prepare_supervoxels_kmeans
from lidal_tpu.runtime.paths import Paths as JaxPaths
from lidal_tpu_torch import config
from lidal_tpu_torch.active import lidal_runner
from lidal_tpu_torch.cli import commands
from lidal_tpu_torch.data import semantic_kitti as sk
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.runtime import checkpoint as ckpt, round as port_round
from lidal_tpu_torch.runtime.paths import Paths
from lidal_tpu_torch.runtime.prob_inference import run_prob_inference
from tests.synth import RAW_IDS, make_mini_sk, mini_cfg
from tests.test_torch_minkunet import NARROW

SEQS = ("00", "01")
FRAMES = 7
N_WORLD, N_SEEN = 1100, 700
N_CLASSES = 19


def port_cfg(jcfg, **kw) -> config.RunConfig:
    """The port's RunConfig with the values of a JAX-package RunConfig."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["data_override"] = config.DataConfig(**dataclasses.asdict(jcfg.data))
    fields.update(kw)
    return config.RunConfig(**fields)


def _static_world_frames(root, seed):
    """Rewrite the tree's frames: frame i of a sequence is N_SEEN points of one
    world of N_WORLD points, seen from the pose make_mini_sk wrote for it (0.5 m
    along x per frame), with 1 cm of noise."""
    rng = np.random.default_rng(seed)
    for seq in SEQS:
        world = (rng.random((N_WORLD, 3)) * np.array([12, 12, 2]) - np.array([6, 6, 1])).astype(np.float32)
        raw = RAW_IDS[rng.integers(0, len(RAW_IDS), N_WORLD)].astype(np.uint32)
        for i in range(FRAMES):
            seen = np.sort(rng.choice(N_WORLD, N_SEEN - 13 * i, replace=False))
            xyz = world[seen] - np.array([0.5 * i, 0, 0], np.float32) + rng.normal(scale=0.01, size=(len(seen), 3))
            sig = rng.random(len(seen))
            frame = os.path.join(root, "sequences", seq, "velodyne", f"{i:06d}.bin")
            np.concatenate([xyz, sig[:, None]], 1).astype(np.float32).tofile(frame)
            raw[seen].tofile(frame.replace("velodyne", "labels")[:-3] + "label")


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """A prepared tree (supervoxels, grids, round-0 flags, by the JAX
    package's prep) and the JAX config that names it."""
    root = str(tmp_path_factory.mktemp("round_tree"))
    make_mini_sk(root, seqs=SEQS, frames_per_seq=FRAMES, points=N_SEEN)
    _static_world_frames(root, seed=1)
    jcfg = mini_cfg(root, seqs=SEQS, r_id=1, data_kw={"train_point_num": len(SEQS) * FRAMES * N_SEEN * 12})
    seq_frames = {s: jax_sk.list_frames(jcfg.data_root, [s]) for s in SEQS}
    prepare_supervoxels_kmeans(jcfg, seq_frames, lambda p: jax_sk.read_frame(p, with_labels=False)[0], n_clusters=6)
    jax_prepare_sk_grids(jcfg)
    jax_bootstrap_round0(jcfg, seq_frames)
    for s in SEQS:  # the 1 % bootstrap labels nothing on 7 frames: label the first frame
        svdir = JaxPaths(jcfg).sv_flag_dir(s, r_id=0)
        for i, name in enumerate(sorted(os.listdir(svdir))):
            flags = np.load(os.path.join(svdir, name))
            flags[:] = int(i == 0)
            np.save(os.path.join(svdir, name), flags)
    return root, jcfg


def _copy_tree(root, dst):
    shutil.copytree(root, dst)
    return str(dst)


def _relocated(cfg, root):
    return dataclasses.replace(
        cfg, data_root=os.path.join(root, "sequences"), processing_root=os.path.join(root, "Processing_files"),
        checkpoint_root=os.path.join(root, "check_points"),
    )


def _flag_files(paths, r_id=None):
    out = {}
    for s in SEQS:
        d = paths.sv_flag_dir(s, r_id=r_id) if r_id is not None else paths.sv_flag_dir(s)
        for name in sorted(os.listdir(d)):
            out[(s, name)] = np.load(os.path.join(d, name))
    return out


def test_staged_round_flags_equal_jax(prepared, tmp_path):
    """Round 1 scored from the same prob npys by both packages: identical
    ``sv_flag`` files, selections and supervoxel statistics."""
    root, jcfg = prepared
    rng = np.random.default_rng(2)
    roots = {k: _copy_tree(root, tmp_path / k) for k in ("jax", "port")}
    jcfg_j = _relocated(jcfg, roots["jax"])
    pcfg = port_cfg(_relocated(jcfg, roots["port"]))
    for s in SEQS:  # the previous round's prob maps (r == 1 reads fr/0r), one set for both
        for f in jax_sk.list_frames(jcfg.data_root, [s]):
            n = len(jax_sk.read_frame(f, with_labels=False)[0])
            prob = rng.dirichlet(0.3 * np.ones(N_CLASSES), n).astype(np.float32)
            for cfg_x, paths_cls in ((jcfg_j, JaxPaths), (pcfg, Paths)):
                d = paths_cls(dataclasses.replace(cfg_x, r_id=0, label_unit="fr")).prob_dir(s)
                os.makedirs(d, exist_ok=True)
                np.save(os.path.join(d, os.path.basename(f)[:-4] + ".npy"), prob)

    want = jax_run_lidal_round(jcfg_j, devices=jax.devices()[:1])
    got = lidal_runner.run_lidal_round(pcfg, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got.al_added) > 0 and len(got.sl_added) > 0
    flags_j, flags_p = _flag_files(JaxPaths(jcfg_j)), _flag_files(Paths(pcfg))
    assert flags_j.keys() == flags_p.keys() and len(flags_p) == len(SEQS) * FRAMES
    for k in flags_j:
        np.testing.assert_array_equal(flags_p[k], flags_j[k])
        assert flags_p[k].dtype == flags_j[k].dtype
    for name in ("sv_pnums.npy", "sv_centers.npy"):
        a = np.load(os.path.join(roots["port"], "Processing_files", "SK", "super_voxel", "KMeans", name))
        b = np.load(os.path.join(roots["jax"], "Processing_files", "SK", "super_voxel", "KMeans", name))
        np.testing.assert_array_equal(a, b)
    # sequence 01's centres are offset by 1000
    centers = np.load(os.path.join(roots["port"], "Processing_files", "SK", "super_voxel", "KMeans", "sv_centers.npy"))
    assert centers[:, 0].max() > 900 and centers[:, 0].min() < 100


@pytest.fixture(scope="module")
def narrow_model():
    torch.manual_seed(5)
    return MinkUNet(num_classes=N_CLASSES, cs=NARROW).eval()


def _read_raw(pcfg):
    by_id = {sk.frame_id(p): p for p in sk.list_frames(pcfg.data_root, SEQS)}
    return lambda seq, name: sk.read_frame(by_id[(seq, name)], with_labels=False)[:2]


def test_fused_round_matches_staged(prepared, narrow_model, tmp_path):
    """One pass of inference feeding the ring == inference to npy files, then
    scoring from them: prob / pred npys, flags and selections identical."""
    root, jcfg = prepared
    cfg_s = port_cfg(_relocated(jcfg, _copy_tree(root, tmp_path / "staged")), r_id=2, inf_reps=2, view_chunk=1)
    cfg_f = port_cfg(_relocated(jcfg, _copy_tree(root, tmp_path / "fused")), r_id=2, inf_reps=2, view_chunk=1)
    for cfg in (cfg_s, cfg_f):  # round-1 flags: what round 2 starts from
        for s in SEQS:
            shutil.copytree(Paths(cfg).sv_flag_dir(s, r_id=0), Paths(cfg).sv_flag_dir(s, r_id=1))

    files = sk.list_frames(cfg_s.data_root, SEQS)
    inf_cfg = lidal_runner._prev_cfg(cfg_s)
    assert (inf_cfg.r_id, inf_cfg.label_unit) == (1, "sv")
    run_prob_inference(inf_cfg, narrow_model, files, lambda p: sk.read_frame(p, with_labels=False), sk.frame_id, device="cpu")
    staged = lidal_runner.run_lidal_round(cfg_s, device="cpu")
    # the default frame index (split order, sorted names) is the order of `files`
    fused = lidal_runner.run_fused_lidal_round(cfg_f, narrow_model, _read_raw(cfg_f), device="cpu")
    for a, b in zip(staged, fused):
        np.testing.assert_array_equal(a, b)
    assert len(staged.al_added) > 0
    flags_s, flags_f = _flag_files(Paths(cfg_s)), _flag_files(Paths(cfg_f))
    for k in flags_s:
        np.testing.assert_array_equal(flags_s[k], flags_f[k])
    ps, pf = Paths(lidal_runner._prev_cfg(cfg_s)), Paths(lidal_runner._prev_cfg(cfg_f))
    for s in SEQS:
        for name in sorted(os.listdir(ps.prob_dir(s))):
            prob = np.load(os.path.join(ps.prob_dir(s), name))
            np.testing.assert_array_equal(prob, np.load(os.path.join(pf.prob_dir(s), name)))
            np.testing.assert_array_equal(
                np.load(os.path.join(ps.pred_dir(s), name)), np.load(os.path.join(pf.pred_dir(s), name))
            )
            assert prob.shape[1] == N_CLASSES and abs(float(prob.sum(1).mean()) - 1) < 1e-5
        assert len(os.listdir(pf.prob_dir(s))) == FRAMES
        assert not os.path.exists(pf.outfeat_dir(s))  # LiDAL rounds >= 1 write no outfeat

    # save_prob=False scores the same and writes no prob maps
    cfg_n = port_cfg(_relocated(jcfg, _copy_tree(root, tmp_path / "nosave")), r_id=2, inf_reps=2, view_chunk=1)
    for s in SEQS:
        shutil.copytree(Paths(cfg_n).sv_flag_dir(s, r_id=0), Paths(cfg_n).sv_flag_dir(s, r_id=1))
    quiet = lidal_runner.run_fused_lidal_round(cfg_n, narrow_model, _read_raw(cfg_n), save_prob=False, device="cpu")
    np.testing.assert_array_equal(quiet.sv_flags, fused.sv_flags)
    assert not os.path.exists(Paths(lidal_runner._prev_cfg(cfg_n)).prob_dir("00"))


def test_fused_round_propagates_writer_failure(prepared, narrow_model, tmp_path, monkeypatch):
    """A failed prob/pred write on the fused round's writer thread fails the
    ROUND: losing a dump silently would corrupt a later staged run that reads it."""
    root, jcfg = prepared
    cfg = port_cfg(_relocated(jcfg, _copy_tree(root, tmp_path / "failing")), r_id=1, inf_reps=2, view_chunk=2)
    real_save = np.save

    def failing_save(path, arr, *a, **k):
        if os.sep + "pred" + os.sep in str(path) and str(path).endswith("000003.npy"):
            raise OSError("disk full (injected)")
        return real_save(path, arr, *a, **k)

    monkeypatch.setattr(np, "save", failing_save)
    with pytest.raises(OSError, match="injected"):
        lidal_runner.run_fused_lidal_round(cfg, narrow_model, _read_raw(cfg), device="cpu")


def test_worker_thread_builds_no_autograd_graph(prepared, tmp_path):
    """The ring's prefetch thread runs the fused round's inference: it must
    enter inference mode itself (the mode is per thread), or every view would
    keep an autograd graph alive."""
    root, jcfg = prepared
    cfg = port_cfg(_relocated(jcfg, _copy_tree(root, tmp_path / "grad")), r_id=1, inf_reps=1)
    torch.manual_seed(6)
    model = MinkUNet(num_classes=N_CLASSES, cs=NARROW).eval()
    assert all(p.requires_grad for p in model.parameters())
    seen = []
    forward = model.forward

    def spying_forward(feats, plan):
        logits, feat = forward(feats, plan)
        seen.append((torch.is_inference_mode_enabled(), logits.requires_grad))
        return logits, feat

    model.forward = spying_forward
    lidal_runner.run_fused_lidal_round(cfg, model, _read_raw(cfg), train_split=("00",), device="cpu")
    assert len(seen) >= FRAMES and all(mode and not grad for mode, grad in seen)


def _check_active_round(root, jcfg, tmp_path, fused, **cfg_kw):
    cfg = port_cfg(_relocated(jcfg, _copy_tree(root, tmp_path / "tree")), r_id=1, inf_reps=2, view_chunk=2,
                   fused_round=fused, max_iter=2, seed=3, **cfg_kw)
    for s in SEQS:
        shutil.copytree(Paths(cfg).sv_flag_dir(s, r_id=0), Paths(cfg).sv_flag_dir(s, r_id=1))
    logs = []
    out = port_round.run_active_round(cfg, 1, evaluate=True, max_iter=2, log=logs.append, device="cpu")
    assert 0.0 <= out["miou"] <= 1.0
    assert os.path.exists(ckpt.ckpt_path(Paths(cfg).ckpt_dir()))
    assert ("fused inference + scoring" in logs[-1]) == fused and len(logs) == (3 if fused else 4)
    before = _flag_files(Paths(cfg), r_id=1)
    after = _flag_files(Paths(dataclasses.replace(cfg, r_id=2)))
    assert before.keys() == after.keys()
    assert all(bool((after[k][before[k] == 1] == 1).all()) for k in before)
    assert sum(int(((after[k] == 1) & (before[k] != 1)).sum()) for k in before) > 0
    for s in SEQS:
        assert len(os.listdir(Paths(cfg).prob_dir(s))) == FRAMES  # the round-1 model's prob maps
    return cfg


@pytest.mark.parametrize("fused", [True, False])
def test_run_active_round_chains_the_stages(prepared, tmp_path, fused):
    """``run_active_round`` for r_id = 1: train -> evaluate -> (fused |
    inference + score); the round-2 flags appear and earlier labels are kept."""
    root, jcfg = prepared
    _check_active_round(root, jcfg, tmp_path, fused)


def test_run_active_round_with_spvcnn(prepared, tmp_path):
    """The same chain with ``model_name="SPVCNN"``: every stage builds,
    restores and calls the point-branch model."""
    root, jcfg = prepared
    cfg = _check_active_round(root, jcfg, tmp_path, True, model_name="SPVCNN")
    saved = torch.load(ckpt.ckpt_path(Paths(cfg).ckpt_dir()), weights_only=True)
    assert "point_transforms.0.0.weight" in saved["model_state"] and saved["iteration"] == 2


def test_spvcnn_fused_round_matches_staged_and_the_jax_flags(prepared, tmp_path):
    """An SPVCNN round: fused == staged in the port, and the JAX package's
    scoring of the port's SPVCNN prob maps writes the same ``sv_flag`` files."""
    root, jcfg = prepared
    torch.manual_seed(7)
    model = SPVCNN(num_classes=N_CLASSES, cs=NARROW).eval()
    kw = dict(r_id=2, inf_reps=2, view_chunk=1, model_name="SPVCNN")
    cfg_s = port_cfg(_relocated(jcfg, _copy_tree(root, tmp_path / "staged")), **kw)
    cfg_f = port_cfg(_relocated(jcfg, _copy_tree(root, tmp_path / "fused")), **kw)
    jcfg_j = dataclasses.replace(_relocated(jcfg, _copy_tree(root, tmp_path / "jax")), r_id=2, model_name="SPVCNN")
    for cfg, paths_cls in ((cfg_s, Paths), (cfg_f, Paths), (jcfg_j, JaxPaths)):
        for s in SEQS:
            shutil.copytree(paths_cls(cfg).sv_flag_dir(s, r_id=0), paths_cls(cfg).sv_flag_dir(s, r_id=1))

    files = sk.list_frames(cfg_s.data_root, SEQS)
    inf_cfg = lidal_runner._prev_cfg(cfg_s)
    run_prob_inference(inf_cfg, model, files, lambda p: sk.read_frame(p, with_labels=False), sk.frame_id, device="cpu")
    staged = lidal_runner.run_lidal_round(cfg_s, device="cpu")
    fused = lidal_runner.run_fused_lidal_round(cfg_f, model, _read_raw(cfg_f), device="cpu")
    for a, b in zip(staged, fused):
        np.testing.assert_array_equal(a, b)
    assert len(staged.al_added) > 0
    flags_s, flags_f = _flag_files(Paths(cfg_s)), _flag_files(Paths(cfg_f))
    ps, pf = Paths(inf_cfg), Paths(lidal_runner._prev_cfg(cfg_f))
    assert os.sep + "SPVCNN" + os.sep in ps.prob_dir("00")
    for s in SEQS:
        assert len(os.listdir(pf.prob_dir(s))) == FRAMES
        for name in sorted(os.listdir(ps.prob_dir(s))):
            np.testing.assert_array_equal(
                np.load(os.path.join(ps.prob_dir(s), name)), np.load(os.path.join(pf.prob_dir(s), name))
            )

    # the JAX package on the port's prob maps
    pj = JaxPaths(dataclasses.replace(jcfg_j, r_id=1))
    for s in SEQS:
        shutil.copytree(ps.prob_dir(s), pj.prob_dir(s))
    want = jax_run_lidal_round(jcfg_j, devices=jax.devices()[:1])
    for g, w in zip(staged, want):
        np.testing.assert_array_equal(g, w)
    flags_j = _flag_files(JaxPaths(jcfg_j))
    assert flags_j.keys() == flags_s.keys() == flags_f.keys() and len(flags_s) == len(SEQS) * FRAMES
    for k in flags_j:
        np.testing.assert_array_equal(flags_s[k], flags_j[k])
        np.testing.assert_array_equal(flags_f[k], flags_j[k])


def test_commands_refuse_what_is_not_ported(tmp_path):
    """Every command is ported: each fails on its first missing input, not on
    ``NotImplementedError``, and the prep stages over the native library run
    over an empty split without building it."""
    # every metric is dispatched: a ReDAL round on an empty tree fails on its first missing input, not on the metric
    cfg = config.RunConfig(metric_name="ReDAL", r_id=1, processing_root=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        commands.score_command(cfg, device="cpu")
    empty = dataclasses.replace(cfg, data_root=str(tmp_path / "no_sequences"))
    for stage in ("supervoxels", "vccs", "boundary"):
        commands.prep_command(empty, stage)
    assert sorted(os.listdir(os.path.join(str(tmp_path), "SK", "super_voxel"))) == ["KMeans", "VCCS"]
    with pytest.raises(FileNotFoundError):
        commands.import_torch_command(cfg, str(tmp_path / "current.pt"), device="cpu")
    with pytest.raises(FileNotFoundError):
        commands._dataset_frames(config.RunConfig(dataset_name="NU", nu_root=str(tmp_path / "no_nuscenes"),
                                                  processing_root=str(tmp_path)), "train")
    with pytest.raises(FileNotFoundError):
        commands._load_eval_variables(config.RunConfig(checkpoint_root=str(tmp_path / "none"),
                                                       data_override=config.DataConfig(name="SK", num_classes=3)), "cpu")
