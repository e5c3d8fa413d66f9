"""The port's recorder (``lidal_tpu_torch/utils/profiling.py``): spans are a
shared no-op with no profiler running; under ``torch.profiler`` they record
counts, totals and self times on every thread and lie in the trace; counters
are exact across threads; ``device_trace`` writes a trace of every thread and
``summary.json``.  A CPU ``run_train`` and a CPU fused round record each span
of their layers once per step or frame."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from lidal_tpu_torch.active import lidal_runner
from lidal_tpu_torch.config import DataConfig, RunConfig
from lidal_tpu_torch.data import semantic_kitti as sk
from lidal_tpu_torch.data.loader import FrameBatchLoader
from lidal_tpu_torch.runtime import train_loop
from lidal_tpu_torch.utils import profiling
from tests.synth import TEST_CAPS, TEST_POINT_CAP, make_mini_sk
from tests.test_torch_round import (  # noqa: F401  (prepared, narrow_model: that module's fixtures)
    FRAMES,
    _copy_tree,
    _read_raw,
    _relocated,
    narrow_model,
    port_cfg,
    prepared,
)

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh_recorder():
    """Each test starts from an empty recorder (a stretch starts at the first
    span after one found no profiler, and tests run back to back)."""
    profiling.reset()


def _spans():
    return profiling.stats()["spans"]


def test_span_without_profiler_is_one_shared_noop():
    a, b = profiling.span("x.a"), profiling.span("x.b")
    assert a is b
    with a as entered:
        assert entered is None
    assert _spans() == {}


def test_nested_spans_count_total_and_self():
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            with profiling.span("t.outer"):
                time.sleep(0.004)
                for _ in range(2):
                    with profiling.span("t.inner"):
                        time.sleep(0.002)
    s = _spans()
    assert s["t.outer"]["count"] == 2 and s["t.inner"]["count"] == 4
    assert s["t.inner"]["total_s"] >= 4 * 0.002 and s["t.inner"]["self_s"] == s["t.inner"]["total_s"]
    assert s["t.outer"]["total_s"] >= 2 * 0.004 + s["t.inner"]["total_s"]
    assert s["t.outer"]["self_s"] == pytest.approx(s["t.outer"]["total_s"] - s["t.inner"]["total_s"], abs=1e-9)
    assert s["t.outer"]["self_s"] >= 2 * 0.004


def test_worker_thread_span_is_recorded_on_its_own_stack():
    def work():
        with profiling.span("t.worker"):
            time.sleep(0.003)

    with torch.profiler.profile(activities=CPU):
        with profiling.span("t.main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    s = _spans()
    assert s["t.worker"]["count"] == 1 and s["t.worker"]["total_s"] >= 0.003
    # the worker's span is not a child of the main thread's
    assert s["t.main"]["self_s"] == s["t.main"]["total_s"]


def test_a_new_profiled_stretch_clears_the_last():
    with torch.profiler.profile(activities=CPU):
        with profiling.span("t.first"):
            pass
    with profiling.span("t.off"):  # off: no record, and the stretch is over
        pass
    assert set(_spans()) == {"t.first"}
    with torch.profiler.profile(activities=CPU):
        with profiling.span("t.second"):
            pass
    assert set(_spans()) == {"t.second"}


def test_count_is_exact_under_eight_threads():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [profiling.count("t.hits") for _ in range(5000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counter("t.hits") == 8 * 5000
    profiling.count("t.bytes", 12)
    assert profiling.stats()["counters"] == {"t.hits": 8 * 5000, "t.bytes": 12}


def test_diverted_counts_stay_out_of_the_counters():
    """Inside ``diverted_counts`` this thread's counts go to its dict (the
    innermost one where they nest); other threads still count."""
    profiling.count("t.launch", 2)
    with profiling.diverted_counts() as kept:
        profiling.count("t.launch", 5)
        profiling.count("t.other")
        worker = threading.Thread(target=lambda: profiling.count("t.launch", 7))
        worker.start()
        worker.join(timeout=60)
        with profiling.diverted_counts() as inner:
            profiling.count("t.inner")
        profiling.count("t.other")
    assert not worker.is_alive()
    assert kept == {"t.launch": 5, "t.other": 2} and inner == {"t.inner": 1}
    assert profiling.stats()["counters"] == {"t.launch": 9}
    profiling.count("t.other")
    assert profiling.counter("t.other") == 1


def test_device_trace_holds_a_worker_span_and_a_summary(tmp_path):
    def work():
        with profiling.span("t.traced_worker"):
            torch.ones(256).cumsum(0)

    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir):
        profiling.count("t.traced_count", 2)
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    files = os.listdir(log_dir)
    files.remove("summary.json")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    worker = [e for e in events if e.get("name") == profiling.PREFIX + "t.traced_worker"]
    assert len(worker) == 1 and worker[0]["tid"] != threading.get_native_id()
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    assert summary["spans"]["t.traced_worker"]["count"] == 1
    assert summary["counters"] == {"t.traced_count": 2}  # reset on entry


TRAIN_MAIN = ("loader.queue_wait", "train.upload", "train.prepare_batch", "train.step", "train.log", "train.checkpoint")


def test_run_train_records_each_span_once_a_step(tmp_path):
    root = str(tmp_path)
    make_mini_sk(root, seqs=("00",), frames_per_seq=8, points=700)
    data = DataConfig(name="SK", num_classes=19, batch_size=2, point_cap=TEST_POINT_CAP, level_caps=TEST_CAPS,
                      train_split=("00",), val_split=())
    cfg = RunConfig(dataset_name="SK", model_name="Mink", r_id=0, ckpt_every=2,
                    data_root=os.path.join(root, "sequences"), processing_root=os.path.join(root, "Processing_files"),
                    checkpoint_root=os.path.join(root, "check_points"), data_override=data)
    loader = FrameBatchLoader(sk.list_frames(cfg.data_root, ["00"]), train_loop.make_sk_read_fn(cfg),
                              point_cap=data.point_cap, batch_size=2)
    marks = []

    def on_step(step, loss):
        s = _spans()
        marks.append((time.perf_counter(), sum(s[n]["total_s"] for n in TRAIN_MAIN if n in s)))

    with torch.profiler.profile(activities=CPU):
        marks.append((time.perf_counter(), 0.0))
        train_loop.run_train(cfg, loader=loader, max_iter=3, log_every=2, on_step=on_step, device="cpu")
    s = _spans()
    for name in ("loader.queue_wait", "train.upload", "train.prepare_batch", "train.step", "train.forward",
                 "train.loss", "train.backward", "train.optimizer"):
        assert s[name]["count"] == 3, (name, s[name])
    assert s["train.log"]["count"] == 1 and s["train.checkpoint"]["count"] == 1  # step 2 (the final save is not)
    assert 3 <= s["loader.read_batch"]["count"] <= 4  # the producer may read ahead
    assert "train.all_reduce" not in s  # no group
    children = sum(s[n]["total_s"] for n in ("train.forward", "train.loss", "train.backward", "train.optimizer"))
    assert s["train.step"]["self_s"] == pytest.approx(s["train.step"]["total_s"] - children, abs=1e-9)
    # between two steps' ends the main thread's top-level spans cover no more than the wall time
    for (t0, c0), (t1, c1) in zip(marks, marks[1:]):
        assert 0 < c1 - c0 <= t1 - t0


def test_fused_round_records_each_span_once_a_frame(prepared, narrow_model, tmp_path):
    root, jcfg = prepared
    cfg = port_cfg(_relocated(jcfg, _copy_tree(root, tmp_path / "traced")), r_id=1, inf_reps=1)
    with torch.profiler.profile(activities=CPU):
        lidal_runner.run_fused_lidal_round(cfg, narrow_model, _read_raw(cfg), train_split=("00",), save_prob=False,
                                           device="cpu")
    s = _spans()
    for name in ("round.wait_prefetch", "round.score", "round.copy_wait", "round.aggregate", "round.read_frame",
                 "round.infer", "round.ring_insert"):
        assert s[name]["count"] == FRAMES, (name, s[name])
    assert s["round.select"]["count"] == 1
    assert all(np.isfinite(v["total_s"]) and 0 <= v["self_s"] <= v["total_s"] + 1e-9 for v in s.values())

