"""``import lidal_tpu_torch`` and every submodule leaves JAX, the JAX package
``lidal_tpu`` and the repository's ``tools`` package unloaded, builds no CUDA
kernel, no native prep library, creates no process group and runs no probe;
``chip_smoke.py`` names none of them.
Runs in a subprocess: this suite's conftest imports jax."""

import ast
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
import lidal_tpu_torch
from lidal_tpu_torch import kernels_build
names = [m.name for m in pkgutil.walk_packages(lidal_tpu_torch.__path__, "lidal_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert "flax" not in sys.modules
jax_package = sorted(m for m in sys.modules if m == "lidal_tpu" or m.startswith("lidal_tpu."))
assert not jax_package, jax_package
assert "tools" not in sys.modules and not any(m.startswith("tools.") for m in sys.modules)
assert not kernels_build._LIBS and not kernels_build.BUILD_LOG, "a kernel was built at import"
from lidal_tpu_torch.utils import profiling
assert profiling.stats()["counters"] == {}, "a kernel was launched or a collective issued at import"
for new in ("ops.devoxelize", "ops.cuda_gather8", "models.spvcnn", "ops.cuda_conv_bf16", "ops.cuda_conv_dxdw_fused",
            "tools.timing", "tools.probe_conv_v3", "tools.probe_int8_gather", "tools.probe_dxdw_features",
            "active.frame_level", "active.frame_runner", "active.redal", "active.redal_runner", "cli.__main__",
            "data.nuscenes", "data.nuscenes_splits", "prep.native", "prep.supervoxel_kmeans", "prep.supervoxel_vccs",
            "prep.surface_variation", "runtime.import_torch", "utils.profiling", "utils.determinism", "utils.pcd",
            "utils.ply"):
    assert "lidal_tpu_torch." + new in names, new
from lidal_tpu_torch.prep import native
assert not native._LIBS and not native.BUILD_LOG, "the native library was built at import"
import torch.distributed
assert not torch.distributed.is_initialized(), "a process group was created at import"
assert profiling.counter("all_reduce.calls") == 0 and "lidal_tpu_torch.parallel.mesh" in names
assert "scipy.spatial" not in sys.modules and "sklearn" not in sys.modules
print(len(names))
"""


def test_import_leaves_jax_out_and_builds_nothing(tmp_path):
    build_dir = os.path.join(_REPO, "lidal_tpu_torch", "_build")
    before = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else []
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().isdigit(), out.stdout  # a probe that ran at import would have printed
    assert int(out.stdout.strip()) > 60  # every module of the slices was imported
    after = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else []
    assert after == before


def _imported_modules(path):
    """Every module name an ``import`` or ``from ... import`` of the file names."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_and_smoke_script_name_no_jax_module():
    """No import statement of the port's files or of ``chip_smoke.py`` (lazy
    ones inside functions included) names jax, flax or the JAX package."""
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_REPO, "lidal_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 63
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "lidal_tpu", "tools"), (path, mod)
    with open(files[0]) as f:
        src = f.read()
    assert "lidal_tpu." not in src.replace("lidal_tpu_torch.", "") and "import jax" not in src
