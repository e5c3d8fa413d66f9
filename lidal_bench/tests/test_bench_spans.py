"""The per-layer metrics read from the program's own spans
(``lidal_tpu_torch.utils.profiling``): a traced CPU run of a train cell and
of the round cell, at the small size of the other harness tests, reports each
of its cell's span metrics as a finite number of ms."""

import math

import pytest

from lidal_bench import run
from lidal_bench.tests.conftest import run_small

SEED = 2**35 + 29

SPAN_METRICS = {
    "sk_minkunet_train": {"loader_queue_wait_ms.train", "batch_upload_ms.train", "batch_prep_ms.train",
                          "step_host_ms.train"},
    "sk_minkunet_round": {"prefetch_wait_ms.round", "infer_host_ms.round", "aggregate_ms.round",
                          "copy_wait_ms.round"},
}


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_traced_run_reports_its_span_metrics(small_layout, one_thread, workload):
    bench, _, _ = small_layout
    _, per_layer = run.cell_metrics(bench, workload)
    assert SPAN_METRICS[workload] <= {m["name"] for m in per_layer}
    out = run_small(small_layout, workload, SEED, trace=True)
    assert out["correct"], out["checks"]
    for name in SPAN_METRICS[workload]:
        value = out["metrics"][name]["value"]
        assert out["metrics"][name]["unit"] == "ms" and math.isfinite(value) and value >= 0, (name, value)
