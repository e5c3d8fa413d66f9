"""The port's nuScenes LiDAL round (``prep/grid.prepare_nu_grids``,
``active/lidal_runner.py``, ``cli/commands.py``) on a mini nuScenes tree, CPU.

The tree is ``tests/test_nuscenes._make_mini_nu``'s (tables in
``v1.0-trainval``) with its frames, ego poses and LIDAR_TOP calibration
rewritten: each scene's keyframes see one static world at nuScenes-sized map
coordinates (x ~ 600-1100 m, y ~ 1200 m) from an ego pose that moves and
turns, through a sensor mounted with a rotation, with 1 cm of noise, so that
registered neighbours match.  Supervoxels, round-0 flags and labels come from
the JAX package's prep.  Held: ``prepare_nu_grids`` npz bit-equal to the JAX
package's; from the same prob maps the port's ``run_lidal_round`` writes the
JAX package's ``sv_flag`` files; the port's fused round equals its staged
round.  ``tests/test_torch_cli.py`` drives the same tree through the command
line.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from lidal_tpu.active.lidal_runner import run_lidal_round as jax_run_lidal_round
from lidal_tpu.data import nuscenes as jnu
from lidal_tpu.data.selection import bootstrap_round0 as jax_bootstrap_round0
from lidal_tpu.prep.grid import prepare_nu_grids as jax_prepare_nu_grids
from lidal_tpu.prep.supervoxel_kmeans import prepare_supervoxels_kmeans
from lidal_tpu.runtime import train_loop as jtrain_loop
from lidal_tpu.runtime.paths import Paths as JaxPaths
from lidal_tpu_torch.active import lidal_runner
from lidal_tpu_torch.cli import commands
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.prep.grid import load_grid_points, prepare_nu_grids
from lidal_tpu_torch.runtime.paths import Paths
from lidal_tpu_torch.runtime.prob_inference import run_prob_inference
from tests.test_torch_minkunet import NARROW
from tests.test_torch_nuscenes import SCENES, make_nu_tree, nu_cfgs
from tests.test_torch_prep_native import native_build_dir  # noqa: F401  (fixture)
from tests.test_torch_round import port_cfg

FRAMES = 7
N_WORLD, N_SEEN = 1100, 700
N_CLASSES = 16
ORIGINS = ((600.0, 1200.0, 5.0), (1100.0, 1210.0, 4.0))  # each scene's world, map coordinates (m)


def _yaw(deg):
    a = np.deg2rad(deg) / 2
    return [float(np.cos(a)), 0.0, 0.0, float(np.sin(a))]


def static_world_nu(root, seed):
    """Rewrite the tree's frames and poses: keyframe k of a scene is
    N_SEEN - 13 k points of one world of N_WORLD points around that scene's
    origin, seen from an ego pose 0.5 m further and 2 degrees more turned each
    keyframe, through LIDAR_TOP mounted 1.8 m up and turned 90 degrees."""
    rng = np.random.default_rng(seed)
    vd = os.path.join(root, "v1.0-trainval")
    tables = {name: json.load(open(os.path.join(vd, f"{name}.json")))
              for name in ("ego_pose", "calibrated_sensor", "sample_data", "lidarseg")}
    cal = tables["calibrated_sensor"][0]
    cal["rotation"], cal["translation"] = _yaw(90.0), [0.9, 0.0, 1.8]
    sensor2ego = jnu.pose_matrix(cal["rotation"], cal["translation"])
    egos = {p["token"]: p for p in tables["ego_pose"]}
    segs = {s["sample_data_token"]: s["filename"] for s in tables["lidarseg"]}
    worlds = {}
    for sd in tables["sample_data"]:
        scene, k = (int(v) for v in sd["sample_token"][1:].split("_"))
        if scene not in worlds:
            w = rng.random((N_WORLD, 3)) * np.array([12, 12, 2]) - np.array([6, 6, 1]) + np.array(ORIGINS[scene])
            worlds[scene] = (w, rng.integers(0, 32, N_WORLD).astype(np.uint8))
        world, raw = worlds[scene]
        ego = egos[sd["ego_pose_token"]]
        ego["rotation"] = _yaw(2.0 * k)
        ego["translation"] = (np.array(ORIGINS[scene]) + [0.5 * k, 0.1 * k, -1.8]).tolist()
        pose = jnu.pose_matrix(ego["rotation"], ego["translation"]) @ sensor2ego
        seen = np.sort(rng.choice(N_WORLD, N_SEEN - 13 * k, replace=False))
        inv = np.linalg.inv(pose)
        xyz = world[seen] @ inv[:3, :3].T + inv[:3, 3] + rng.normal(scale=0.01, size=(len(seen), 3))
        cols = np.concatenate([xyz, rng.random((len(seen), 1)), np.zeros((len(seen), 1))], 1)
        cols.astype(np.float32).tofile(os.path.join(root, sd["filename"]))
        raw[seen].tofile(os.path.join(root, segs[sd["token"]]))
    for name in ("ego_pose", "calibrated_sensor"):
        with open(os.path.join(vd, f"{name}.json"), "w") as f:
            json.dump(tables[name], f)


@pytest.fixture(scope="module")
def prepared(tmp_path_factory, native_build_dir):  # noqa: F811
    """A prepared tree (supervoxels, round-0 flags with each scene's first
    frame labelled, by the JAX package's prep) and the JAX config naming it
    with both scenes as its train split, as ``--train_seqs`` names them."""
    root = make_nu_tree(str(tmp_path_factory.mktemp("nu_round")), samples=FRAMES, points=N_SEEN)
    static_world_nu(root, seed=1)
    jcfg, _ = nu_cfgs(root, r_id=1, data_kw={"train_point_num": len(SCENES) * FRAMES * N_SEEN * 12})
    seq_frames = jtrain_loop.nu_seq_frames(jcfg)
    prepare_supervoxels_kmeans(jcfg, seq_frames, lambda e: jnu.read_frame(e, with_labels=False)[0], n_clusters=6)
    jax_bootstrap_round0(jcfg, seq_frames)
    for s in SCENES:  # the 1 % bootstrap labels nothing on 7 frames: label the first frame
        svdir = JaxPaths(jcfg).sv_flag_dir(s, r_id=0)
        for i, name in enumerate(sorted(os.listdir(svdir))):
            flags = np.load(os.path.join(svdir, name))
            flags[:] = int(i == 0)
            np.save(os.path.join(svdir, name), flags)
    return root, jcfg


def _copy(root, dst, jcfg):
    shutil.copytree(root, dst)
    return dataclasses.replace(jcfg, nu_root=str(dst), processing_root=os.path.join(dst, "Processing_files"),
                               checkpoint_root=os.path.join(dst, "check_points"))


def _flag_files(paths, r_id=None):
    out = {}
    for s in SCENES:
        d = paths.sv_flag_dir(s, r_id=r_id) if r_id is not None else paths.sv_flag_dir(s)
        for name in sorted(os.listdir(d)):
            out[(s, name)] = np.load(os.path.join(d, name))
    return out


def test_nu_grids_equal_jax_at_map_coordinates(prepared, tmp_path):
    root, jcfg = prepared
    jcfg_j = _copy(root, tmp_path / "jax", jcfg)
    pcfg = port_cfg(_copy(root, tmp_path / "port", jcfg))
    jax_prepare_nu_grids(jcfg_j)
    prepare_nu_grids(pcfg)
    for s, origin in zip(SCENES, ORIGINS):
        names = sorted(os.listdir(Paths(pcfg).grid_dir(s)))
        assert names == sorted(os.listdir(JaxPaths(jcfg_j).grid_dir(s))) and len(names) == FRAMES
        for name in names:
            a = load_grid_points(os.path.join(Paths(pcfg).grid_dir(s), name))
            b = load_grid_points(os.path.join(JaxPaths(jcfg_j).grid_dir(s), name))
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            assert np.abs(a.mean(0) - origin).max() < 10  # registered into map coordinates


@pytest.fixture(scope="module")
def gridded(prepared, tmp_path_factory):
    """The prepared tree with the JAX package's grids."""
    root, jcfg = prepared
    jcfg = _copy(root, tmp_path_factory.mktemp("gridded") / "tree", jcfg)
    jax_prepare_nu_grids(jcfg)
    return jcfg


def test_nu_staged_round_flags_equal_jax(gridded, tmp_path):
    """Round 1 scored from the same prob npys by both packages: identical
    ``sv_flag`` files, selections and supervoxel statistics."""
    rng = np.random.default_rng(2)
    jcfg_j = _copy(gridded.nu_root, tmp_path / "jax", gridded)
    pcfg = port_cfg(_copy(gridded.nu_root, tmp_path / "port", gridded))
    for s, entries in jtrain_loop.nu_seq_frames(jcfg_j).items():  # the previous round's prob maps (fr/0r)
        for e in entries:
            n = len(jnu.read_frame(e, with_labels=False)[0])
            prob = rng.dirichlet(0.3 * np.ones(N_CLASSES), n).astype(np.float32)
            for cfg_x, paths_cls in ((jcfg_j, JaxPaths), (pcfg, Paths)):
                d = paths_cls(dataclasses.replace(cfg_x, r_id=0, label_unit="fr")).prob_dir(s)
                os.makedirs(d, exist_ok=True)
                np.save(os.path.join(d, f"{e['token']}.npy"), prob)

    want = jax_run_lidal_round(jcfg_j, devices=jax.devices()[:1])
    got = lidal_runner.run_lidal_round(pcfg, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got.al_added) > 0
    flags_j, flags_p = _flag_files(JaxPaths(jcfg_j)), _flag_files(Paths(pcfg))
    assert flags_j.keys() == flags_p.keys() and len(flags_p) == len(SCENES) * FRAMES
    for k in flags_j:
        np.testing.assert_array_equal(flags_p[k], flags_j[k])
        assert flags_p[k].dtype == flags_j[k].dtype


def test_nu_fused_round_matches_staged(gridded, tmp_path):
    """One pass of inference feeding the ring == inference to npy files, then
    scoring from them, with the frames enumerated as the commands enumerate
    them (manifest order, ids (scene, token)): prob / pred npys, flags and
    selections identical."""
    torch.manual_seed(5)
    model = MinkUNet(num_classes=N_CLASSES, cs=NARROW).eval()
    cfgs = [port_cfg(_copy(gridded.nu_root, tmp_path / k, gridded), r_id=2, inf_reps=2, view_chunk=1)
            for k in ("staged", "fused")]
    for cfg in cfgs:  # round-1 flags: what round 2 starts from
        for s in SCENES:
            shutil.copytree(Paths(cfg).sv_flag_dir(s, r_id=0), Paths(cfg).sv_flag_dir(s, r_id=1))
    cfg_s, cfg_f = cfgs
    files, read_fn, frame_id = commands._dataset_frames(cfg_s, "train")
    assert [frame_id(e) for e in files][:2] == [(SCENES[0], "sd_s0_0"), (SCENES[0], "sd_s0_1")]
    run_prob_inference(lidal_runner._prev_cfg(cfg_s), model, files, lambda e: read_fn(e, with_labels=False),
                       frame_id, device="cpu")
    staged = lidal_runner.run_lidal_round(cfg_s, device="cpu")

    files, read_fn, frame_id = commands._dataset_frames(cfg_f, "train")
    by_id = {frame_id(e): e for e in files}
    fused = lidal_runner.run_fused_lidal_round(
        cfg_f, model, lambda seq, name: read_fn(by_id[(seq, name)], with_labels=False)[:2],
        frame_index={frame_id(e): i for i, e in enumerate(files)}, device="cpu",
    )
    for a, b in zip(staged, fused):
        np.testing.assert_array_equal(a, b)
    assert len(staged.al_added) > 0
    flags_s, flags_f = _flag_files(Paths(cfg_s)), _flag_files(Paths(cfg_f))
    assert flags_s.keys() == flags_f.keys()
    for k in flags_s:
        np.testing.assert_array_equal(flags_s[k], flags_f[k])
    ps, pf = Paths(lidal_runner._prev_cfg(cfg_s)), Paths(lidal_runner._prev_cfg(cfg_f))
    for s in SCENES:
        assert sorted(os.listdir(pf.prob_dir(s))) == sorted(os.listdir(ps.prob_dir(s))) and len(os.listdir(ps.prob_dir(s))) == FRAMES
        for name in os.listdir(ps.prob_dir(s)):
            np.testing.assert_array_equal(np.load(os.path.join(ps.prob_dir(s), name)),
                                          np.load(os.path.join(pf.prob_dir(s), name)))
            np.testing.assert_array_equal(np.load(os.path.join(ps.pred_dir(s), name)),
                                          np.load(os.path.join(pf.pred_dir(s), name)))
