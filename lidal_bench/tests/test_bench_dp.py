"""The data-parallel training loop (``loops/train_dp.py``) with 4 gloo ranks
on the CPU, one frame a rank, so the 3 checked steps span two epochs: a
sound run is correct, its rate counts the global batch's points, its traced
run reports rank 0's per-layer metrics, and neither rank 0 stepping on the
wrong labels nor a sum over the group left out in every rank (``control_dp``:
the gradients', the BNs') is correct."""

import json

import pytest
import torch

from lidal_bench import control_dp
from lidal_bench.loops import train_dp
from lidal_bench.tests.conftest import run_small

SEED = 2**35 + 21


@pytest.fixture
def dp_layout(small_layout):
    bench, layout, work = small_layout
    f = layout / "traffic" / "train_b5_dp4.json"
    tr = json.loads(f.read_text())
    tr.update(frames=8, batch_size=1)
    f.write_text(json.dumps(tr))
    return train_dp.with_cell(bench), layout, work


def test_four_gloo_ranks_read_correct(dp_layout, one_thread):
    out = run_small(dp_layout, "sk_minkunet_train_dp4", SEED, seconds=1.0)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_points_per_s", "train_step_p90_ms", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_traced_dp_run_reports_rank_zeros_metrics(dp_layout, one_thread):
    out = run_small(dp_layout, "sk_minkunet_train_dp4", SEED + 1, trace=True)
    assert out["correct"], out["checks"]
    assert {"step_host_ms.train", "loader_wait_ms.train", "loader_queue_wait_ms.train", "batch_upload_ms.train",
            "batch_prep_ms.train", "conv_fwd_roofline.train", "conv_bwd_roofline.train"} <= set(out["metrics"])
    assert "device_idle.train" not in out["metrics"]


def test_rank_zero_dropping_its_labels_is_not_correct(dp_layout, one_thread, monkeypatch):
    """Rank 0 steps with its frame's labels all ignored (every collective still
    runs): the global loss and step leave the reference's."""
    from lidal_tpu_torch.runtime import train_loop

    orig = train_loop.train_step

    def unlabelled(state, batch, seeds=None, group=None):
        return orig(state, batch._replace(labels=torch.full_like(batch.labels, 255)), seeds, group)

    monkeypatch.setattr(train_loop, "train_step", unlabelled)
    out = run_small(dp_layout, "sk_minkunet_train_dp4", SEED + 2, seconds=1.0)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", control_dp.FAULTS)
def test_sum_over_the_group_left_out_is_not_correct(dp_layout, one_thread, fault):
    with control_dp.planted(fault):
        out = run_small(dp_layout, "sk_minkunet_train_dp4", SEED + 3, seconds=1.0)
    assert not out["correct"], (fault, out["checks"])
