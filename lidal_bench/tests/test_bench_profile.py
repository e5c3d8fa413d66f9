"""The reduction of a profiler trace to busy time, idle share and labelled gaps."""

import json

import pytest

from lidal_bench.profile import reduce_trace


def test_busy_window_and_labelled_gaps(tmp_path):
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 50, "dur": 100},  # overlaps k1
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 400, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 600, "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": "lidal_bench.prepare", "ts": 140, "dur": 300},
        {"ph": "X", "cat": "user_annotation", "name": "lidal_bench.loader_next", "ts": 500, "dur": 90},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 1000},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = reduce_trace(str(path))
    assert abs(r["busy_s"] - 650e-6) < 1e-12 and abs(r["window_s"] - 1000e-6) < 1e-12
    assert r["device_ops"][0] == ["k1", 500e-6]
    assert [g[0] for g in r["idle_gaps"]] == ["host: prepare", "host: loader_next"]
    assert [g[1] for g in r["idle_gaps"]] == pytest.approx([250e-6, 100e-6])


def test_trace_without_device_activity(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps([{"ph": "X", "cat": "cpu_op", "name": "a", "ts": 0, "dur": 5}]))
    assert reduce_trace(str(path))["busy_s"] == 0.0
