"""``import lidal_tpu_torch`` and every submodule leaves JAX and the JAX package
``lidal_tpu`` unloaded and builds no CUDA kernel; ``chip_smoke.py`` names neither.
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
assert not kernels_build._LIBS and not kernels_build.BUILD_LOG, "a kernel was built at import"
for new in ("ops.devoxelize", "ops.cuda_gather8", "models.spvcnn"):
    assert "lidal_tpu_torch." + new in names, new
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
    assert int(out.stdout.strip()) > 38  # every module of the slices was imported
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
    assert len(files) >= 40
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "lidal_tpu"), (path, mod)
    with open(files[0]) as f:
        src = f.read()
    assert "lidal_tpu." not in src.replace("lidal_tpu_torch.", "") and "import jax" not in src
