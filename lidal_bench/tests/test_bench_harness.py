"""Whole runs of the harness on the CPU at a small size (no look for a card):
a sound run is correct; runs with the timed path broken underneath are not;
a configuration, traffic and metric added as files are picked up."""

import json

import pytest
import torch

from lidal_bench.tests.conftest import run_small

SEED = 2**35 + 11


def test_sound_run_is_correct_and_reports_its_metrics(small_layout, one_thread):
    out = run_small(small_layout, "sk_minkunet_train", SEED)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_points_per_s", "train_step_p90_ms", "setup_s"}
    assert list(out)[-1] == "checks" and out["attempted"] >= 1 and out["failed"] == 0
    assert all(r["value"] <= r["limit"] for r in out["checks"])


def test_traced_spvcnn_run_reports_its_per_layer_metrics(small_layout, one_thread):
    out = run_small(small_layout, "sk_spvcnn_train", SEED + 1, trace=True)
    assert out["correct"], out["checks"]
    # no device on the CPU: no idle share; the kernel groups and the loader are read
    assert {"loader_wait_ms.train", "mfu.train", "conv_fwd_roofline.train", "conv_bwd_roofline.train",
            "point_branch_roofline.train"} <= set(out["metrics"])
    assert "device_idle.train" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out


def _frozen(orig):
    def train_step(state, batch, seeds=None, group=None):
        from lidal_tpu_torch.data.pipeline import forward_batch
        from lidal_tpu_torch.runtime.train import cross_entropy_ignore

        state.model.train()
        with torch.no_grad():
            loss = cross_entropy_ignore(forward_batch(state.model, batch, seeds)[0], batch.labels)
        state.step += 1
        return loss
    return train_step


def _half_batch(orig):
    def train_step(state, batch, seeds=None, group=None):
        labels = batch.labels.clone()
        labels[labels.shape[0] // 2:] = 255
        return orig(state, batch._replace(labels=labels), seeds, group)
    return train_step


@pytest.mark.parametrize("fault", [_frozen, _half_batch], ids=["state_unchanged", "half_batch"])
def test_broken_step_is_not_correct(small_layout, one_thread, monkeypatch, fault):
    from lidal_tpu_torch.runtime import train_loop

    monkeypatch.setattr(train_loop, "train_step", fault(train_loop.train_step))
    out = run_small(small_layout, "sk_minkunet_train", SEED + 2)
    assert not out["correct"], out["checks"]


def test_added_files_are_picked_up_without_edits(small_layout, one_thread):
    """A new configuration, traffic mix and per-layer metric are files and
    entries only; nothing in the committed layout changes."""
    bench, layout, work = small_layout
    before = {p: p.read_bytes() for p in layout.rglob("*") if p.is_file()}
    cfg = json.loads((layout / "configs" / "minkunet_sk.json").read_text())
    cfg["level_caps"] = [4096, 2048, 1024, 512, 128]
    (layout / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    tr = json.loads((layout / "traffic" / "train_b5.json").read_text())
    tr["batch_size"] = 1
    (layout / "traffic" / "dummy_mix.json").write_text(json.dumps(tr))
    (layout / "metrics" / "dummy_steps.train.py").write_text(
        "def read(rec):\n    return float(len(rec['intervals']))\n")
    (layout / "limits" / "dummy_cell.json").write_text((layout / "limits" / "sk_minkunet_train.json").read_text())
    bench["configs"].append({"name": "dummy_cfg", "source": "x", "file": str(layout / "configs" / "dummy_cfg.json"),
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg", "traffic": "dummy_mix", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("dummy_cell")
    bench["per_layer"].append({"name": "dummy_steps.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "x", "moves": "train_points_per_s",
                               "workloads": ["dummy_cell"]})
    out = run_small((bench, layout, work), "dummy_cell", SEED + 3, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["dummy_steps.train"]["value"] >= 1
    assert all(before[p] == p.read_bytes() for p in before)


def test_round_run_is_correct(small_layout, one_thread):
    out = run_small(small_layout, "sk_minkunet_round", SEED + 4, trace=True)
    assert out["correct"], out["checks"]
    assert {"mfu.round", "conv_fwd_roofline.round"} <= set(out["metrics"])
    assert out["attempted"] >= 6 and list(out)[-1] == "checks"


def _altered_selection(mod):
    orig = mod.select

    def select(*a, **k):
        res = orig(*a, **k)
        flags = res.sv_flags.copy()
        flags[int((flags == 0).argmax())] = 1
        return res._replace(sv_flags=flags)
    return "select", select


def _altered_probs(mod):
    orig = mod.make_multiview_fn

    def make(*a, **k):
        fn = orig(*a, **k)

        def run(*b):
            prob, pred, feat = fn(*b)
            return prob.roll(1, dims=-1), pred, feat
        return run
    return "make_multiview_fn", make


def _altered_scores(mod):
    orig = mod.score_slot

    def score_slot(*a, **k):
        return orig(*a, **k) * 1.01
    return "score_slot", score_slot


@pytest.mark.parametrize("fault", [_altered_selection, _altered_probs, _altered_scores],
                         ids=["selection", "probabilities", "scores"])
def test_round_with_an_altered_answer_is_not_correct(small_layout, one_thread, monkeypatch, fault):
    from lidal_tpu_torch.active import lidal, lidal_runner

    mod = lidal_runner if fault is _altered_probs else lidal
    monkeypatch.setattr(mod, *fault(mod))
    out = run_small(small_layout, "sk_minkunet_round", SEED + 5)
    assert not out["correct"], out["checks"]
