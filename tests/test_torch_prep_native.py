"""The port's native prep (``lidal_tpu_torch/prep/native.py``,
``supervoxel_kmeans.py``, ``supervoxel_vccs.py``, ``surface_variation.py``)
against the JAX package on the same inputs, CPU.

* the host build: ``csrc/vccs.cpp`` and ``csrc/balanced_kmeans.cpp`` compiled by
  g++ with ``csrc/Makefile``'s flags into a library named by a hash of the
  sources, the flags and this host's ``-march=native``; a changed source gets
  a new library, a failing compile raises with the compiler's output;
* labels: ``balanced_kmeans`` (the native library, and the numpy greedy loop
  under ``prefer_native=False``), ``vccs_cluster`` and ``vccs_frame_info``
  equal to the JAX package's, whose native calls go through the committed
  ``csrc/liblidal_native.so`` (also built with the Makefile's
  ``-march=native``, on another host: equal labels here say the two builds
  agree on these inputs);
* ``prepare_supervoxels_kmeans`` / ``_vccs`` write the same npz trees and
  ``id2sv.npz``;
* ``surface_variation`` (scipy ``cKDTree`` in the port, sklearn ``KDTree`` in
  the JAX package) within 1e-6, and ``prepare_surface_variation``'s trees.

The tests build the library under a temporary directory, not the checkout's
``lidal_tpu_torch/_build/``.
"""

import dataclasses
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

from lidal_tpu.data import semantic_kitti as jax_sk
from lidal_tpu.prep import native as jax_native
from lidal_tpu.prep import supervoxel_kmeans as jax_kmeans
from lidal_tpu.prep import supervoxel_vccs as jax_vccs
from lidal_tpu.prep import surface_variation as jax_sv
from lidal_tpu_torch.prep import native, supervoxel_kmeans, supervoxel_vccs, surface_variation
from tests.synth import make_mini_sk, mini_cfg
from tests.test_torch_round import port_cfg

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def native_build_dir(tmp_path_factory):
    """The native library built once per session under a temporary directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", tmp_path_factory.mktemp("native_build"))
        native.load()
        yield native.BUILD_DIR


def _frames(seed, n_frames=3, n=3000):
    rng = np.random.default_rng(seed)
    return [(rng.random((n + 97 * i, 3)) * np.array([40, 40, 3])).astype(np.float32) for i in range(n_frames)]


def test_build_is_named_by_its_sources_and_rebuilds_on_change(tmp_path, monkeypatch):
    # the module's own default, read from a fresh copy of it: the session fixture
    # native_build_dir (used by other files a worker may have run first) patches BUILD_DIR
    spec = importlib.util.find_spec(native.__name__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert fresh.BUILD_DIR == Path(_REPO, "lidal_tpu_torch", "_build")
    assert native.CSRC == Path(_REPO, "csrc")
    src = tmp_path / "csrc"
    src.mkdir()
    for name in native.SOURCES:
        (src / name).write_bytes((native.CSRC / name).read_bytes())
    monkeypatch.setattr(native, "CSRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    first = native.library_path()
    assert first.parent == tmp_path / "_build" and first.name.startswith("liblidal_native-")
    lib = native.load()
    assert first.exists() and native.BUILD_LOG[first][0] > 0
    assert native.load() is lib  # loaded once
    labels = native.balanced_kmeans_native(_frames(0, 1)[0])
    assert sorted(np.unique(labels)) == list(range(20))

    with open(src / "vccs.cpp", "a") as f:
        f.write("\n// a changed source\n")
    second = native.library_path()
    assert second != first and not second.exists()
    native.load()
    assert second.exists() and first.exists() and native.BUILD_LOG[second][0] > 0
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == sorted([first.name, second.name])


def test_failing_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "vccs.cpp").write_text("int vccs_cluster( {\n")
    (src / "balanced_kmeans.cpp").write_bytes((native.CSRC / "balanced_kmeans.cpp").read_bytes())
    monkeypatch.setattr(native, "CSRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g..? failed to build(.|\n)*vccs.cpp"):
        native.load()
    assert not any((tmp_path / "_build").iterdir())  # no library and no partial file left
    with pytest.raises(RuntimeError, match="failed to build"):
        supervoxel_kmeans.balanced_kmeans(_frames(1, 1)[0])  # no quiet fallback to numpy


def test_balanced_kmeans_native_equals_jax(native_build_dir):
    assert jax_native.native_available()
    for xyz in _frames(2):
        for k, tol, seed in ((20, 0.05, 0), (7, 0.1, 3)):
            got = supervoxel_kmeans.balanced_kmeans(xyz, n_clusters=k, size_tol=tol, seed=seed)
            want = jax_kmeans.balanced_kmeans(xyz, n_clusters=k, size_tol=tol, seed=seed)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.int32 and len(np.unique(got)) == k


def test_balanced_kmeans_numpy_equals_jax():
    for xyz in _frames(3, n_frames=2, n=400):
        got = supervoxel_kmeans.balanced_kmeans(xyz, n_clusters=6, prefer_native=False)
        want = jax_kmeans.balanced_kmeans(xyz, n_clusters=6, prefer_native=False)
        np.testing.assert_array_equal(got, want)
        assert np.bincount(got).max() <= max(int(len(xyz) * 1.05 / 6), -(-len(xyz) // 6))


def test_vccs_labels_and_frame_info_equal_jax(native_build_dir):
    for xyz in _frames(4):
        got = native.vccs_cluster(xyz, voxel_res=0.5, seed_res=4.0)
        want = jax_native.vccs_cluster(xyz, voxel_res=0.5, seed_res=4.0)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64 and len(np.unique(got)) > 5
        for min_points in (100, 20):
            p2s, kept = supervoxel_vccs.vccs_frame_info(got, min_points)
            p2s_j, kept_j = jax_vccs.vccs_frame_info(want, min_points)
            np.testing.assert_array_equal(p2s, p2s_j)
            assert kept == kept_j and p2s.dtype == np.int32


@pytest.fixture(scope="module")
def sk_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prep_tree"))
    make_mini_sk(root, seqs=("00", "01"), frames_per_seq=3, points=2500, seed=8)
    return root


def _tree(base):
    """{relative path: array(s)} of every npy / npz file under ``base``."""
    out = {}
    for d, _, names in os.walk(base):
        for name in sorted(names):
            path = os.path.join(d, name)
            rel = os.path.relpath(path, base)
            if name.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: z[k] for k in z.files}
            elif name.endswith(".npy"):
                out[rel] = {"": np.load(path)}
    return out


def _assert_trees_equal(a, b):
    ta, tb = _tree(a), _tree(b)
    assert ta.keys() == tb.keys() and ta
    for rel in ta:
        assert ta[rel].keys() == tb[rel].keys(), rel
        for k in ta[rel]:
            np.testing.assert_array_equal(ta[rel][k], tb[rel][k], err_msg=rel)
            assert ta[rel][k].dtype == tb[rel][k].dtype, rel


@pytest.mark.parametrize("stage", ["kmeans", "vccs", "boundary"])
def test_prepare_trees_equal_jax(sk_tree, native_build_dir, tmp_path, stage):
    jcfg = dataclasses.replace(mini_cfg(sk_tree), processing_root=str(tmp_path / "jax"))
    pcfg = port_cfg(jcfg, processing_root=str(tmp_path / "port"))
    seq_frames = {s: jax_sk.list_frames(jcfg.data_root, [s]) for s in jcfg.data.train_split}

    def read_xyz(p):
        return jax_sk.read_frame(p, with_labels=False)[0]

    if stage == "kmeans":
        jax_kmeans.prepare_supervoxels_kmeans(jcfg, seq_frames, read_xyz, n_clusters=8)
        supervoxel_kmeans.prepare_supervoxels_kmeans(pcfg, seq_frames, read_xyz, n_clusters=8)
    elif stage == "vccs":
        jax_vccs.prepare_supervoxels_vccs(jcfg, seq_frames, read_xyz, seed_res=4.0)
        supervoxel_vccs.prepare_supervoxels_vccs(pcfg, seq_frames, read_xyz, seed_res=4.0)
    else:
        jax_sv.prepare_surface_variation(jcfg, seq_frames, read_xyz)
        surface_variation.prepare_surface_variation(pcfg, seq_frames, read_xyz)
    _assert_trees_equal(str(tmp_path / "jax"), str(tmp_path / "port"))
    if stage != "boundary":
        part = "KMeans" if stage == "kmeans" else "VCCS"
        with np.load(str(tmp_path / "port" / "SK" / "super_voxel" / part / "id2sv.npz")) as z:
            assert len(z["seq"]) == len(z["frame"]) == len(z["local"]) > 0


def test_surface_variation_within_1e6_of_jax():
    rng = np.random.default_rng(9)
    for n, k in ((4000, 50), (300, 50), (30, 50), (500, 7)):
        xyz = (rng.random((n, 3)) * np.array([30, 30, 2])).astype(np.float32)
        xyz[: n // 4, 2] = 0.0  # a plane: sigma 0 there
        got = surface_variation.surface_variation(xyz, k=k)
        want = jax_sv.surface_variation(xyz, k=k)
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert got.max() <= surface_variation.CLIP
