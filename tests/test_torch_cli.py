"""The port's argparse front end (``python -m lidal_tpu_torch.cli``): the same
subcommands, flags and defaults as ``lidal_tpu.cli`` plus ``--device`` and
``--bf16_route``, a
frame-level round driven end to end on the CPU over
``tests/synth.make_mini_sk``: prep -> train -> prob-inference -> score -> train
(``evaluate_command`` is driven by ``tests/test_torch_round.py``), and a
nuScenes LiDAL round over the mini tree of ``tests/test_torch_nu_round.py``:
every prep stage -> train -> prob-inference -> score -> train -> evaluate ->
fused-score."""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from lidal_tpu.cli import __main__ as jax_cli
from lidal_tpu_torch import config
from lidal_tpu_torch.cli import __main__ as cli
from lidal_tpu_torch.runtime import checkpoint as ckpt
from lidal_tpu_torch.runtime.paths import Paths
from tests.synth import make_mini_sk
from tests.test_torch_nu_round import FRAMES as NU_FRAMES, N_CLASSES as NU_CLASSES, prepared  # noqa: F401
from tests.test_torch_nuscenes import SCENES
from tests.test_torch_prep_native import native_build_dir  # noqa: F401  (fixture of `prepared`)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 60  # round(0.01 * 60) = 1 frame per round


def _run_args(module):
    parser = argparse.ArgumentParser()
    module._add_run_args(parser)
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_flags_and_defaults_equal_the_jax_cli():
    want, got = _run_args(jax_cli), _run_args(cli)
    assert set(got) == set(want) | {"device", "bf16_route"} and got["device"].default == "cuda"
    assert got["bf16_route"].default is False  # the bf16 route is opt-in: f32 by default
    for name, action in want.items():
        assert (got[name].default, got[name].type, type(got[name])) == (action.default, action.type, type(action)), name
    args = argparse.Namespace(**{k: a.default for k, a in got.items()})
    assert cli._cfg(args) == config.RunConfig()  # the flags' defaults are the config's


def test_overrides_reach_the_config():
    parser = argparse.ArgumentParser()
    cli._add_run_args(parser)
    args = parser.parse_args(["--metric_name", "ENT", "--label_unit", "fr", "--r_id", "2", "--batch_size", "3",
                              "--level_caps", "64,32,16,8,4", "--train_seqs", "00,02", "--no_fused_round",
                              "--reference_parity", "--device", "cpu"])
    cfg = cli._cfg(args)
    assert (cfg.metric_name, cfg.label_unit, cfg.r_id, cfg.fused_round, cfg.reference_parity) == ("ENT", "fr", 2, False, True)
    assert (cfg.data.batch_size, cfg.data.level_caps, cfg.data.train_split) == (3, (64, 32, 16, 8, 4), ("00", "02"))
    assert args.device == "cpu"


@pytest.mark.parametrize("argv", [[], ["nope"], ["prep"], ["import-torch"], ["score", "--r_id", "x"]])
def test_bad_command_lines_exit(argv):
    with pytest.raises(SystemExit):
        cli.main(argv)


@pytest.mark.parametrize("argv,match", [
    (["prep", "--stage", "supervoxels"], "ROADMAP item 18"),
    (["prep", "--stage", "vccs"], "ROADMAP item 18"),
    (["prep", "--stage", "boundary"], "ROADMAP item 18"),
    (["prep", "--stage", "grids", "--dataset_name", "NU"], "ROADMAP item 18"),
    (["import-torch", "--pt_path", "current.pt"], "ROADMAP item 20"),
])
def test_unported_subcommands_say_which_item_they_wait_for(tmp_path, monkeypatch, argv, match):
    """These subcommands raised ``NotImplementedError`` until ``match`` ported
    them.  Now, in an empty directory, the SemanticKITTI prep stages run over
    no frames and write their (empty) outputs, and the nuScenes prep and
    ``import-torch`` fail on their first missing input."""
    assert match in ("ROADMAP item 18", "ROADMAP item 20")
    monkeypatch.chdir(tmp_path)
    if "--dataset_name" in argv or argv[0] == "import-torch":
        with pytest.raises(FileNotFoundError):
            cli.main(argv + ["--device", "cpu"])
    else:
        assert cli.main(argv + ["--device", "cpu"]) == 0
        part = {"supervoxels": "KMeans", "vccs": "VCCS"}.get(argv[-1])
        if part is not None:
            with np.load(os.path.join("Processing_files", "SK", "super_voxel", part, "id2sv.npz")) as z:
                assert len(z["seq"]) == 0
    with pytest.raises(ValueError, match="unknown prep stage"):
        cli.main(["prep", "--stage", "nope"])


def test_cli_frame_level_round_on_the_cpu(tmp_path, monkeypatch):
    d = str(tmp_path)
    make_mini_sk(d, seqs=("00",), frames_per_seq=FRAMES, points=200)
    monkeypatch.chdir(d)
    common = [
        "--dataset_name", "SK", "--model_name", "Mink", "--data_root", "sequences",
        "--processing_root", "Processing_files", "--checkpoint_root", "check_points",
        "--train_seqs", "00", "--val_seqs", "00", "--batch_size", "2", "--point_cap", "256",
        "--level_caps", "256,128,64,32,16", "--label_unit", "fr", "--metric_name", "ENT", "--inf_reps", "1",
        "--device", "cpu",
    ]
    parser = argparse.ArgumentParser()
    cli._add_run_args(parser)
    paths = [Paths(cli._cfg(parser.parse_args(common + ["--r_id", str(r)]))) for r in (0, 1)]
    assert cli.main(["prep", "--stage", "grids"] + common) == 0
    assert len(os.listdir(paths[0].grid_dir("00"))) == FRAMES
    assert cli.main(["prep", "--stage", "bootstrap"] + common) == 0
    flags0 = np.load(os.path.join(paths[0].frame_flag_dir(r_id=0), "00.npy"))
    assert flags0.shape == (FRAMES,) and flags0.sum() == 1

    assert cli.main(["train", "--max_iter", "1", "--r_id", "0"] + common) == 0
    assert os.path.exists(ckpt.ckpt_path(paths[0].ckpt_dir()))
    assert cli.main(["prob-inference", "--r_id", "0"] + common) == 0
    prob_dir = paths[0].prob_dir("00")
    assert len(os.listdir(prob_dir)) == FRAMES

    # the selection itself through ``python -m``, as a user runs it
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    out = subprocess.run([sys.executable, "-m", "lidal_tpu_torch.cli", "score", "--r_id", "1"] + common,
                         cwd=d, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    flags1 = np.load(os.path.join(paths[1].frame_flag_dir(), "00.npy"))
    assert flags1.dtype == bool and flags1[flags0].all() and flags1.sum() == 2

    # the frame it added has the largest mean entropy among the unlabelled
    def entropy(name):
        p = np.load(os.path.join(prob_dir, name)).astype(np.float64)
        return float(-(np.where(p > 0, p * np.log(np.where(p > 0, p, 1.0)), 0.0)).sum(1).mean())

    scores = np.array([entropy(n) for n in sorted(os.listdir(prob_dir))])
    scores[flags0] = -np.inf
    assert int(np.flatnonzero(flags1 & ~flags0)[0]) == int(scores.argmax())

    # the next round trains on both frames
    assert cli.main(["train", "--max_iter", "1", "--r_id", "1"] + common) == 0
    assert os.path.exists(ckpt.ckpt_path(paths[1].ckpt_dir()))


def test_cli_nu_round_on_the_cpu(prepared, tmp_path, monkeypatch):
    """``python -m lidal_tpu_torch.cli`` with ``--dataset_name NU`` over the
    default ``nuScenes`` root, its ``splits.json`` training on the first scene
    and validating on the second: every prep stage, then train (r0) ->
    prob-inference -> score (LiDAL, r1, the scene named by ``--train_seqs``)
    -> train (r1) -> evaluate -> fused-score (r2), and run-experiment."""
    root, _ = prepared
    shutil.copytree(root, tmp_path / "nuScenes", ignore=shutil.ignore_patterns("Processing_files"))
    with open(tmp_path / "nuScenes" / "splits.json", "w") as f:
        json.dump({"train": [SCENES[0]], "val": [SCENES[1]]}, f)
    monkeypatch.chdir(tmp_path)
    scene = SCENES[0]
    common = ["--dataset_name", "NU", "--model_name", "Mink", "--train_seqs", scene,
              "--batch_size", "2", "--point_cap", "1024", "--level_caps", "1024,1024,512,256,64", "--inf_reps", "1",
              "--max_iter", "1", "--device", "cpu"]
    parser = argparse.ArgumentParser()
    cli._add_run_args(parser)
    cfg = cli._cfg(parser.parse_args(common))
    assert (cfg.data.name, cfg.data.num_classes, cfg.data.train_split) == ("NU", NU_CLASSES, (scene,))
    for stage in ("grids", "supervoxels", "vccs", "boundary", "bootstrap"):
        assert cli.main(["prep", "--stage", stage] + common) == 0
    paths = Paths(cfg)
    assert len(os.listdir(paths.grid_dir(scene))) == len(os.listdir(paths.supervoxel_dir(scene, "VCCS"))) == NU_FRAMES
    assert len(os.listdir(paths.boundary_dir(scene))) == len(os.listdir(paths.supervoxel_dir(scene, "KMeans"))) == NU_FRAMES
    assert not os.path.exists(paths.grid_dir(SCENES[1]))  # the val scene is not prepared
    # the 1 % bootstrap labels nothing on 7 frames: label two frames and their supervoxels
    np.save(os.path.join(paths.frame_flag_dir(r_id=0), f"{scene}.npy"), np.arange(NU_FRAMES) < 2)
    svdir = paths.sv_flag_dir(scene, r_id=0)
    for i, name in enumerate(sorted(os.listdir(svdir))):
        np.save(os.path.join(svdir, name), np.full(len(np.load(os.path.join(svdir, name))), int(i < 2), np.int32))

    assert cli.main(["train", "--r_id", "0", "--label_unit", "fr"] + common) == 0
    assert cli.main(["prob-inference", "--r_id", "0", "--label_unit", "fr"] + common) == 0
    r0 = Paths(dataclasses.replace(cfg, r_id=0, label_unit="fr"))
    assert len(os.listdir(r0.prob_dir(scene))) == NU_FRAMES
    assert np.load(os.path.join(r0.prob_dir(scene), "sd_s0_3.npy")).shape[1] == NU_CLASSES
    assert cli.main(["score", "--r_id", "1"] + common) == 0
    r1, r0_sv = Paths(dataclasses.replace(cfg, r_id=1)), Paths(dataclasses.replace(cfg, r_id=0))
    new = sum(int(((np.load(os.path.join(r1.sv_flag_dir(scene), n)) == 1)
                   & (np.load(os.path.join(r0_sv.sv_flag_dir(scene), n)) != 1)).sum())
              for n in os.listdir(r1.sv_flag_dir(scene)))
    assert new > 0
    assert cli.main(["train", "--r_id", "1"] + common) == 0
    assert os.path.exists(ckpt.ckpt_path(r1.ckpt_dir()))
    assert cli.main(["evaluate", "--r_id", "1"] + common) == 0
    assert cli.main(["fused-score", "--r_id", "2"] + common) == 0
    r2 = Paths(dataclasses.replace(cfg, r_id=2))
    assert len(os.listdir(r2.sv_flag_dir(scene))) == len(os.listdir(r1.prob_dir(scene))) == NU_FRAMES
    # round 0 once more as one command: its (resumed) training, inference and round-1 scoring
    assert cli.main(["run-experiment", "--rounds", "1", "--no-eval", "--label_unit", "fr", "--metric_name", "ENT"]
                    + common) == 0
    ent = Paths(dataclasses.replace(cfg, r_id=1, label_unit="fr", metric_name="ENT")).frame_flag_dir()
    assert os.listdir(ent) == [f"{scene}.npy"]
