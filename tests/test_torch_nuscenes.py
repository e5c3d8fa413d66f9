"""The port's nuScenes path (``lidal_tpu_torch/data/nuscenes.py``,
``nuscenes_splits.py``, the NU branches of ``runtime/train_loop.py`` and
``cli/commands.py``) against the JAX package, CPU, on the synthetic v1.0
tables of ``tests/test_nuscenes._make_mini_nu`` (its table directory renamed to
``v1.0-trainval``, the version ``build_manifest`` reads by default).

Held bit-equal: manifests and their pickle cache read across the packages,
``read_frame`` and the label map, every ``load_splits`` precedence branch
(warning included), ``_dataset_frames`` order and ids, the NU train loaders'
entry lists in the r0 / full / fr / sv / sv-pseudo modes and their shuffled
batches (masked labels, pseudo-labels) for one seed.  One narrow NU train
step: loss rtol 1e-5, every gradient within 1e-4 of its largest JAX entry.
And the scoring rounds' split: ``NU_CONFIG`` has no ``train_split``, so a NU
scoring round scores only the scenes a caller names (``--train_seqs``), in
both packages alike.
"""

import dataclasses
import json
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.active.frame_runner import run_frame_metric_round as jax_run_frame_metric_round
from lidal_tpu.active.lidal_runner import run_lidal_round as jax_run_lidal_round
from lidal_tpu.cli import commands as jax_commands
from lidal_tpu.config import NU_CONFIG as JAX_NU_CONFIG
from lidal_tpu.data import nuscenes as jnu
from lidal_tpu.data import nuscenes_splits as jsplits
from lidal_tpu.models import MinkUNet as JaxMinkUNet
from lidal_tpu.ops import kernel_map as jkm
from lidal_tpu.runtime import train as jtrain
from lidal_tpu.runtime.import_torch import convert_minkunet_state_dict as jax_convert_minkunet
from lidal_tpu.runtime import train_loop as jtrain_loop
from lidal_tpu.runtime.paths import Paths as JaxPaths
from lidal_tpu_torch import config
from lidal_tpu_torch.active import frame_runner, lidal_runner
from lidal_tpu_torch.cli import commands
from lidal_tpu_torch.data import nuscenes as nu
from lidal_tpu_torch.data import nuscenes_splits as splits
from lidal_tpu_torch.data import selection
from lidal_tpu_torch.data.pipeline import prepare_train_batch
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.runtime import train_loop
from lidal_tpu_torch.runtime.import_torch import export_minkunet_state_dict
from lidal_tpu_torch.runtime.train import cross_entropy_ignore
from lidal_tpu_torch.runtime.weights import _to_torch
from tests.synth import mini_cfg
from tests.test_nuscenes import _make_mini_nu
from tests.test_torch_minkunet import NARROW
from tests.test_torch_round import port_cfg

SCENES = ("scene-0000", "scene-0001")
CAPS = (512, 256, 128, 64, 32)


def make_nu_tree(root, samples, points, seed=0):
    """The mini v1.0 tree of ``_make_mini_nu`` under ``root``, tables in
    ``v1.0-trainval``, and a ``splits.json`` training on both scenes."""
    _make_mini_nu(root, n_scenes=len(SCENES), samples_per_scene=samples, points=points, seed=seed)
    os.rename(os.path.join(root, "v1.0-mini"), os.path.join(root, "v1.0-trainval"))
    with open(os.path.join(root, "splits.json"), "w") as f:
        json.dump({"train": list(SCENES), "val": [SCENES[1]]}, f)
    return root


def nu_cfgs(root, nu_root=None, **kw):
    """(JAX config, port config) of a NU run over ``root``: 16 classes,
    batch 2, the test caps; ``data_kw`` overrides the data config."""
    data_kw = {"name": "NU", "num_classes": 16, "batch_size": 2, **kw.pop("data_kw", {})}
    jcfg = mini_cfg(root, seqs=SCENES, data_kw=data_kw, **kw)
    jcfg = dataclasses.replace(jcfg, dataset_name="NU", nu_root=nu_root or root)
    return jcfg, port_cfg(jcfg)


def assert_entries_equal(got, want):
    """Two lists of manifest entries (dicts with a 4x4 pose) are equal."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    return make_nu_tree(str(tmp_path_factory.mktemp("nu_small")), samples=4, points=300)


def test_manifest_and_its_cache_read_across_packages(small_tree, tmp_path):
    want = jnu.build_manifest(small_tree)
    got = nu.build_manifest(small_tree)
    assert list(got) == list(want) == list(SCENES) and len(got[SCENES[0]]) == 4
    for s in SCENES:
        assert_entries_equal(got[s], want[s])
    # each package reads the other's cache, bit for bit (and does not rebuild from the tables)
    for writer, reader in ((jnu, nu), (nu, jnu)):
        cache = str(tmp_path / writer.__name__.split(".")[0] / "NU" / "manifest.pkl")
        writer.build_manifest(small_tree, cache_path=cache)
        assert os.path.exists(cache)
        read = reader.build_manifest(os.path.join(small_tree, "absent"), cache_path=cache)
        for s in SCENES:
            assert_entries_equal(read[s], want[s])


def test_read_frame_label_map_and_poses_equal(small_tree):
    assert nu.LEARNING_MAP == jnu.LEARNING_MAP and (nu.NUM_CLASSES, nu.IGNORE) == (jnu.NUM_CLASSES, jnu.IGNORE)
    np.testing.assert_array_equal(nu.build_label_map(), jnu.build_label_map())
    for e in nu.build_manifest(small_tree)[SCENES[1]]:
        for with_labels in (True, False):
            got, want = nu.read_frame(e, with_labels), jnu.read_frame(e, with_labels)
            for a, b in zip(got, want):
                if b is None:
                    assert a is None
                else:
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    for _ in range(5):
        q, t = rng.normal(size=4), rng.normal(size=3) * 1000
        np.testing.assert_array_equal(nu.pose_matrix(q, t), jnu.pose_matrix(q, t))
    np.testing.assert_array_equal(nu.quaternion_to_rotation([0, 0, 0, 0]), jnu.quaternion_to_rotation([0, 0, 0, 0]))
    assert splits.OFFICIAL_VAL == jsplits.OFFICIAL_VAL and splits.TRAINVAL_SCENES == jsplits.TRAINVAL_SCENES


class _Devkit:
    """A stand-in for ``nuscenes.utils.splits`` as the devkit installs it."""

    @staticmethod
    def create_splits_scenes():
        return {"train": ["scene-0005", "scene-0001"], "val": ["scene-0003", "scene-0999"]}


@pytest.mark.parametrize("branch", ["splits_json", "devkit", "official", "fallback"])
def test_load_splits_precedence_equals_jax(tmp_path, monkeypatch, branch):
    names = [f"scene-{i:04d}" for i in (range(1090, 1110) if branch == "fallback" else range(20))]
    devkit = _Devkit if branch == "devkit" else None  # None: `import nuscenes` raises ImportError
    monkeypatch.setitem(sys.modules, "nuscenes", devkit)
    monkeypatch.setitem(sys.modules, "nuscenes.utils", devkit)
    monkeypatch.setitem(sys.modules, "nuscenes.utils.splits", devkit)
    path = str(tmp_path / "splits.json")
    if branch == "splits_json":
        with open(path, "w") as f:
            json.dump({"train": names[:5], "val": names[5:8]}, f)
    results = []
    for pkg in (nu, jnu):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results.append(pkg.load_splits(names, path))
        warned = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
        assert (branch == "fallback") == any("85/15" in m for m in warned), warned
    assert results[0] == results[1]
    train, val = results[0]
    want = {
        "splits_json": (names[:5], names[5:8]),
        "devkit": (["scene-0005", "scene-0001"], ["scene-0003"]),
        "official": ([s for s in names if s not in splits.OFFICIAL_VAL], [s for s in names if s in splits.OFFICIAL_VAL]),
        "fallback": (names[:17], names[17:]),
    }[branch]
    assert (list(train), list(val)) == (list(want[0]), list(want[1]))


def test_dataset_frames_order_and_ids_equal(small_tree, tmp_path):
    jcfg, pcfg = nu_cfgs(small_tree)
    pcfg = dataclasses.replace(pcfg, processing_root=str(tmp_path / "port"))
    for split in ("train", "val"):
        files_j, read_j, fid_j = jax_commands._dataset_frames(jcfg, split)
        files_p, read_p, fid_p = commands._dataset_frames(pcfg, split)
        assert_entries_equal(files_p, files_j)
        assert [fid_p(e) for e in files_p] == [fid_j(e) for e in files_j]
        assert fid_p(files_p[0]) == (files_p[0]["scene"], files_p[0]["token"])
        for a, b in zip(read_p(files_p[-1], with_labels=True), read_j(files_j[-1], with_labels=True)):
            np.testing.assert_array_equal(a, b)
    assert len(commands._dataset_frames(pcfg, "train")[0]) == 8 and len(files_p) == 4
    assert os.path.exists(os.path.join(pcfg.processing_root, "NU", "manifest.pkl"))


@pytest.fixture(scope="module")
def list_tree(tmp_path_factory):
    """150 keyframes of 60 points per scene (the 1 % bootstrap draws 2), with
    round-1 supervoxel tables, sv flags (0 / 1 human / 2 pseudo), frame flags
    and round-0 pred dumps for the pseudo-labels."""
    root = make_nu_tree(str(tmp_path_factory.mktemp("nu_lists")), samples=150, points=60, seed=3)
    jcfg, _ = nu_cfgs(root, r_id=1, metric_name="LiDAL", label_unit="sv")
    rng = np.random.default_rng(4)
    seq_frames = jtrain_loop.nu_seq_frames(jcfg)
    paths = JaxPaths(jcfg)
    prev = JaxPaths(dataclasses.replace(jcfg, r_id=0, label_unit="fr"))
    pseudo = JaxPaths(dataclasses.replace(jcfg, metric_name="LiDAL_pseudo"))
    fr_dir = JaxPaths(dataclasses.replace(jcfg, label_unit="fr")).frame_flag_dir()
    os.makedirs(fr_dir)
    for scene, entries in seq_frames.items():
        for d in (paths.supervoxel_dir(scene), paths.sv_flag_dir(scene), pseudo.sv_flag_dir(scene),
                  prev.pred_dir(scene)):
            os.makedirs(d, exist_ok=True)
        for i, e in enumerate(entries):
            name, n_sv = selection.frame_name(e), 5
            selection.save_sv_info(os.path.join(paths.supervoxel_dir(scene), f"{name}.npz"),
                                   rng.integers(-1, n_sv, 60), np.arange(n_sv) + 100 * i)
            flags = rng.integers(0, 3, n_sv) if i % 3 else np.zeros(n_sv, np.int64)  # every 3rd frame unlabelled
            for d in (paths.sv_flag_dir(scene), pseudo.sv_flag_dir(scene)):
                np.save(os.path.join(d, f"{name}.npy"), flags)
            np.save(os.path.join(prev.pred_dir(scene), f"{name}.npy"), rng.integers(0, 16, 60).astype(np.int32))
        np.save(os.path.join(fr_dir, f"{scene}.npy"), rng.random(len(entries)) < 0.2)
    return root


@pytest.mark.parametrize(
    "r_id,label_unit,metric",
    [(0, "fr", "LiDAL"), (1, "sv", "full"), (1, "fr", "LiDAL"), (1, "sv", "LiDAL"), (1, "sv", "LiDAL_pseudo")],
)
def test_nu_train_lists_and_batches_match_jax(list_tree, r_id, label_unit, metric):
    jcfg, pcfg = nu_cfgs(list_tree, r_id=r_id, label_unit=label_unit, metric_name=metric)
    want = jtrain_loop.build_train_loader(jcfg)  # writes the round-0 tree first when r_id == 0
    got = train_loop.build_train_loader(pcfg)
    assert_entries_equal(got.files, want.files)
    assert len(got.files) > 0 and (got.point_cap, got.batch_size, got.seed) == (want.point_cap, want.batch_size, want.seed)
    if r_id == 0:
        assert len(got.files) == 4  # round(0.01 * 150) = 2 draws a scene
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        batches = list(zip(got, want))
        assert len(batches) == -(-len(got.files) // 2)
        for a, b in batches:
            assert [e["token"] for e in a["files"]] == [e["token"] for e in b["files"]]
            for k in ("xyz", "sig", "valid", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
    labels = np.concatenate([got.read_fn(e)[2] for e in got.files])
    if label_unit == "sv" and metric != "full":
        assert (labels == 255).any() and (labels != 255).any()
    if metric == "LiDAL_pseudo":  # flag-2 supervoxels carry the round-0 predictions
        plain = np.concatenate([train_loop._build_nu_train_loader(
            dataclasses.replace(pcfg, metric_name="LiDAL")).read_fn(e)[2] for e in got.files])
        assert (labels != plain).any()


def test_nu_train_step_matches_jax(small_tree):
    """One narrow NU step (16 classes) on the first batch of the NU loader.
    The JAX model gets the port's batch (``prepare_train_batch`` is held
    bit-equal in ``test_torch_train.py``) and the port's seeded weights
    through ``export_minkunet_state_dict`` and the JAX package's
    ``convert_minkunet_state_dict``."""
    jcfg, pcfg = nu_cfgs(small_tree, r_id=1, metric_name="full")
    batch = next(iter(train_loop.build_train_loader(pcfg, shuffle=False)))
    assert batch["n_frames"] == 2 and set(np.unique(batch["labels"])) <= set(range(16)) | {255}
    tb = prepare_train_batch(None, *(torch.as_tensor(batch[k]) for k in ("xyz", "sig", "valid", "labels")),
                             level_caps=CAPS, augment=False)
    to_j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    def jax_tuple(cls, t):  # the JAX package's fields by name (the port's plans also hold the row orders)
        return cls(**{f: to_j(getattr(t, f)) for f in cls._fields})

    plan_j = jkm.UNetPlan(tuple(jax_tuple(jkm.LevelPlan, lv) for lv in tb.plan.levels),
                          tuple(jax_tuple(jkm.DownPlan, d) for d in tb.plan.downs))
    torch.manual_seed(3)
    model = MinkUNet(num_classes=16, cs=NARROW)
    variables = jax_convert_minkunet(export_minkunet_state_dict(model.state_dict()))
    model_j = JaxMinkUNet(num_classes=16, cs=NARROW)

    def loss_fn(params):
        (logits, _), _ = model_j.apply({"params": params, "batch_stats": variables["batch_stats"]}, to_j(tb.feats),
                                       plan_j, train=True, mutable=["batch_stats"])
        return jtrain.cross_entropy_ignore(logits, to_j(tb.labels))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    logits, _ = model.train()(tb.feats, tb.plan)
    loss = cross_entropy_ignore(logits, tb.labels)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    want = _to_torch(jax.tree_util.tree_map(np.asarray, grads_j))
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * max(1e-3, np.abs(w).max()), err_msg=name)
    assert all(float(p.grad.abs().max()) > 0 for n, p in named.items() if n.endswith("kernel"))


def test_nu_scoring_rounds_score_only_the_scenes_named(small_tree, tmp_path):
    """``NU_CONFIG.train_split`` is empty in both packages, and the scoring
    runners read their split from it unless the caller names the scenes: a NU
    round then scores no scene and selects nothing, in both alike."""
    assert config.NU_CONFIG.train_split == JAX_NU_CONFIG.train_split == ()
    jcfg, pcfg = nu_cfgs(small_tree, r_id=1, data_kw={"train_split": ()})
    jcfg = dataclasses.replace(jcfg, processing_root=str(tmp_path / "jax"))
    pcfg = dataclasses.replace(pcfg, processing_root=str(tmp_path / "port"))
    assert pcfg.data.train_split == () and len(train_loop.nu_seq_frames(pcfg)) == 2  # the loader has its scenes
    got = lidal_runner.run_lidal_round(pcfg, device="cpu")
    want = jax_run_lidal_round(jcfg, devices=jax.devices()[:1])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got.sv_flags) == 0 and len(got.al_added) == 0
    # a frame-level round has no flags to concatenate: both packages raise alike
    with pytest.raises(ValueError, match="at least one array"):
        frame_runner.run_frame_metric_round(dataclasses.replace(pcfg, metric_name="ENT", label_unit="fr"), "ENT",
                                            device="cpu")
    with pytest.raises(ValueError, match="at least one array"):
        jax_run_frame_metric_round(dataclasses.replace(jcfg, metric_name="ENT", label_unit="fr"), "ENT")
    written = [sorted(os.path.relpath(os.path.join(d, f), root) for d, _, names in os.walk(root) for f in names
                      if f.endswith(".npy")) for root in (tmp_path / "jax", tmp_path / "port")]
    assert written[0] == written[1] and not [f for f in written[1] if "flag" in f]  # no flag file, empty statistics
