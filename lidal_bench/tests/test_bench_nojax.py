"""The harness's refusal of JAX and of the JAX package, by whole top-level names."""

import io
import json
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from lidal_bench import run


def test_top_level_names_compare_whole():
    assert run.forbidden_modules(["lidal_tpu_torch", "lidal_tpu_torch.ops.conv", "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["lidal_tpu", "lidal_tpu.ops", "jax", "jax.numpy", "jaxlib", "flax.linen",
                                  "torch"]) == ["flax.linen", "jax", "jax.numpy", "jaxlib", "lidal_tpu",
                                                "lidal_tpu.ops"]


def test_no_card_exits_without_a_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "sk_minkunet_train", "--seed", str(2**33), "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""


def test_harness_and_port_load_no_jax():
    """A fresh process that imports the harness, its loops, every metric
    reader and the port's training loop holds neither JAX nor the JAX package."""
    code = ("import sys; from lidal_bench import run; import lidal_bench.loops.train, lidal_bench.control; "
            "b = run.load_bench(); run.readers(b['per_layer']); import lidal_tpu_torch.runtime.train_loop; "
            "print(run.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_card_run_prints_one_json_line(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert run.main(["--workload", "sk_minkunet_train", "--seed", str(2**33 + 1), "--seconds", "2"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(line)
    assert res["correct"] and list(res)[-1] == "checks"
