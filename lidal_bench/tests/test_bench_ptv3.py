"""The PTv3 training loop (``loops/train_ptv3.py``) at a small size on the
CPU: a sound run is correct and reports its per-layer metrics; the program
with each of the four faults of ``control_ptv3`` planted is not; the
reference imports nothing of the port, of JAX or of the JAX package.

At these sizes on the CPU the limits are the CPU's own (the committed ones
were set at the cell's size on the card): a sound run reads about 7e-8 on
``loss_gap``, 6e-5 on ``grad1_gap`` and 1.5e-4 on ``delta_gap``; the
emulated TF32 fault, the faint one, about 5e-5, 1.2e-3 and 8.7e-3."""

import json
import subprocess
import sys

import pytest

from lidal_bench import control_ptv3, run
from lidal_bench.tests.conftest import run_small

SEED = 2**35 + 11
CPU_LIMITS = {"loss_gap": 5e-6, "grad1_gap": 4e-4, "delta_gap": 3e-3}


@pytest.fixture
def ptv3_layout(small_layout):
    bench, layout, work = small_layout
    f = layout / "traffic" / "train_b5_ptv3.json"
    tr = json.loads(f.read_text())
    tr.update(frames=8, batch_size=2)
    f.write_text(json.dumps(tr))
    f = layout / "limits" / "sk_ptv3_train.json"
    lim = json.loads(f.read_text())
    for k, v in CPU_LIMITS.items():
        lim[k]["limit"] = v
    f.write_text(json.dumps(lim))
    return bench, layout, work


def test_sound_ptv3_run_is_correct_and_reports_its_metrics(ptv3_layout, one_thread):
    out = run_small(ptv3_layout, "sk_ptv3_train", SEED, trace=True)
    assert out["correct"], out["checks"]
    assert {"mfu.train", "conv_fwd_roofline.train", "conv_bwd_roofline.train", "step_host_ms.train",
            "attn_fwd_roofline.train", "serialize_ms.train", "loader_wait_ms.train", "loader_queue_wait_ms.train",
            "batch_upload_ms.train", "batch_prep_ms.train"} <= set(out["metrics"])
    assert out["metrics"]["attn_fwd_roofline.train"]["value"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", control_ptv3.FAULTS)
def test_planted_fault_is_not_correct(ptv3_layout, one_thread, fault):
    with control_ptv3.planted(fault):
        out = run_small(ptv3_layout, "sk_ptv3_train", SEED)
    assert not out["correct"], (fault, out["checks"])


def test_reference_imports_no_port_jax_or_jax_package():
    code = ("import sys; import lidal_bench.reference.ptv3, lidal_bench.loops.train_ptv3, lidal_bench.work.ptv3; "
            "print(sorted(n for n in sys.modules if n.split('.')[0] in ('lidal_tpu_torch', 'lidal_tpu', 'jax', "
            "'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
