"""``import lidal_tpu_torch`` and every submodule leaves JAX unloaded and builds
no CUDA kernel.  Runs in a subprocess: this suite's conftest imports jax."""

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
assert not kernels_build._LIBS and not kernels_build.BUILD_LOG, "a kernel was built at import"
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
    assert int(out.stdout.strip()) >= 15  # every module of the slice was imported
    after = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else []
    assert after == before
