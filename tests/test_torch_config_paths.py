"""The port's own ``config.py``, ``runtime/paths.py`` and ``prep/poses.py``
against the JAX package's: the same fields and defaults, the same path strings
for every method over a grid of configurations, the same poses.  (The port
imports nothing of the JAX package; only the tests import both.)"""

import dataclasses
import itertools

import numpy as np
import pytest

from lidal_tpu import config as jax_config
from lidal_tpu.prep import grid as jax_grid, poses as jax_poses
from lidal_tpu.runtime import paths as jax_paths
from lidal_tpu_torch import config
from lidal_tpu_torch.prep import grid, poses
from lidal_tpu_torch.runtime import paths
from tests.synth import make_mini_sk


def _fields(cls):
    return [(f.name, f.type, f.default, f.default_factory) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["DataConfig", "RunConfig"])
def test_config_fields_and_defaults_equal(name):
    assert _fields(getattr(config, name)) == _fields(getattr(jax_config, name))


@pytest.mark.parametrize("name", ["SK_CONFIG", "NU_CONFIG"])
def test_dataset_constants_equal(name):
    assert dataclasses.asdict(getattr(config, name)) == dataclasses.asdict(getattr(jax_config, name))


def test_run_config_properties_equal():
    for ds, model in itertools.product(("SK", "NU"), ("Mink", "SPVCNN", "MinkUNet_x")):
        a, b = config.RunConfig(dataset_name=ds, model_name=model), jax_config.RunConfig(dataset_name=ds, model_name=model)
        assert dataclasses.asdict(a.data) == dataclasses.asdict(b.data) and a.is_spvcnn == b.is_spvcnn
    over = config.DataConfig(name="SK", num_classes=3, point_cap=64)
    assert config.RunConfig(data_override=over).data is over


_GRID = list(itertools.product(
    ("SK", "NU"), ("Mink", "SPVCNN"), ("fr", "sv"), ("LiDAL", "LiDAL_pseudo", "ReDAL", "RAND", "full", "ENT"), (0, 1, 3)
))


@pytest.mark.parametrize("dataset", ["SK", "NU"])
def test_paths_give_the_same_strings(dataset):
    checked = 0
    for ds, model, unit, metric, r in _GRID:
        if ds != dataset:
            continue
        kw = dict(dataset_name=ds, model_name=model, label_unit=unit, metric_name=metric, r_id=r,
                  processing_root="/p/Processing_files", checkpoint_root="/c/check_points")
        a, b = paths.Paths(config.RunConfig(**kw)), jax_paths.Paths(jax_config.RunConfig(**kw))
        assert a.metric == b.metric
        calls = [("ckpt_dir", ()), ("ckpt_dir", (2,)), ("ckpt_dir", (0,)),
                 ("prob_dir", ("03",)), ("prob_dir", ("03", 0)), ("pred_dir", ("03",)), ("pred_dir", ("03", 2)),
                 ("outfeat_dir", ("03",)), ("outfeat_dir", ("03", 0)),
                 ("frame_flag_dir", ()), ("frame_flag_dir", (0,)), ("frame_flag_dir", (2, "RAND")), ("frame_flag_dir", (2, "ENT")),
                 ("sv_flag_dir", ("03",)), ("sv_flag_dir", ("03", 0)), ("sv_flag_dir", ("03", 2, "ReDAL")),
                 ("sv_flag_dir", ("03", 2, "RAND")), ("supervoxel_dir", ("03",)), ("supervoxel_dir", ("03", "VCCS")),
                 ("grid_dir", ("03",)), ("boundary_dir", ("03",))]
        if r > 0:
            calls.append(("warm_start_ckpt_dir", ()))
        for method, args in calls:
            assert getattr(a, method)(*args) == getattr(b, method)(*args), (kw, method, args)
            checked += 1
    assert checked > 1000
    public = lambda cls: sorted(n for n in vars(cls) if not n.startswith("__"))  # noqa: E731
    assert public(paths.Paths) == public(jax_paths.Paths)


def test_ensure_dir_makes_and_returns(tmp_path):
    target = str(tmp_path / "a" / "b")
    assert paths.ensure_dir(target) == target == jax_paths.ensure_dir(target)


def test_poses_and_registered_grids_equal_jax(tmp_path):
    """``prep/poses.py`` and ``prep/grid.prepare_sk_grids``: the same poses
    and the same registered points, file for file."""
    root_a, root_b = tmp_path / "port", tmp_path / "jax"
    for root in (root_a, root_b):
        make_mini_sk(str(root), seqs=("00",), frames_per_seq=3, points=200, seed=3)
    seq_dir = str(root_a / "sequences" / "00")
    for got, want in zip(poses.sequence_poses(seq_dir), jax_poses.sequence_poses(seq_dir)):
        np.testing.assert_array_equal(got, want)
    xyz = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    pose = poses.sequence_poses(seq_dir)[2]
    np.testing.assert_array_equal(poses.transform_points(xyz, pose), jax_poses.transform_points(xyz, pose))

    def cfg_of(mod, root):
        data = mod.DataConfig(name="SK", num_classes=19, train_split=("00", "07"))  # "07" is absent: skipped
        return mod.RunConfig(data_root=str(root / "sequences"), processing_root=str(root / "proc"), data_override=data)

    grid.prepare_sk_grids(cfg_of(config, root_a))
    jax_grid.prepare_sk_grids(cfg_of(jax_config, root_b))
    for i in range(3):
        a = grid.load_grid_points(str(root_a / "proc" / "SK" / "grid" / "00" / f"{i:06d}.npz"))
        b = jax_grid.load_grid_points(str(root_b / "proc" / "SK" / "grid" / "00" / f"{i:06d}.npz"))
        assert a.dtype == np.float32 and a.shape[1] == 3
        np.testing.assert_array_equal(a, b)
