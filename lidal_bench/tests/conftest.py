"""Fixtures of the benchmark's own tests: a copy of the benchmark's layout
shrunk to a size the CPU runs in seconds (the port runs its kernels' plain
versions on CPU tensors)."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from lidal_bench import run

SMALL_CAPS = [4096, 2048, 1024, 512, 256]


def shrink(layout: Path) -> None:
    for f in (layout / "traffic").glob("*.json"):
        tr = json.loads(f.read_text())
        tr["scan"].update(beams=16, azimuths=256)
        if tr["loop"] == "train":
            tr.update(frames=8, batch_size=2)
        else:  # neighbour ids past the ends of so short a sequence are clamped into it
            tr.update(frames=6, inf_reps=1, view_chunk=1)
        f.write_text(json.dumps(tr))
    # the committed limits were set at the cells' own sizes on the card; at these
    # sizes on the CPU a sound run reads up to ~1.2e-2 on delta_gap (Adam's first
    # steps amplify the f32 rounding of small gradients), a broken step 1 (state
    # unchanged) or more than 1e-1 on loss_gap (half of the batch); one view
    # of a round reads up to ~1.1e-4 on prob_gap
    for f in (layout / "limits").glob("*.json"):
        lim = json.loads(f.read_text())
        for k, v in {"loss_gap": 2e-3, "grad1_gap": 1e-2, "delta_gap": 5e-2, "prob_gap": 1e-3}.items():
            if k in lim:
                lim[k]["limit"] = v
        f.write_text(json.dumps(lim))
    for f in (layout / "configs").glob("*.json"):
        cf = json.loads(f.read_text())
        cf.update(point_cap=4096, level_caps=SMALL_CAPS)
        f.write_text(json.dumps(cf))


@pytest.fixture
def small_layout(tmp_path):
    """(bench dict, layout dir, work dir): the committed layout copied and
    shrunk, the configurations' files pointing into the copy."""
    layout = tmp_path / "lidal_bench"
    shutil.copytree(Path(run.HERE), layout, ignore=shutil.ignore_patterns("__pycache__"))
    shrink(layout)
    bench = run.load_bench()
    for c in bench["configs"]:
        c["file"] = str(layout / "configs" / f"{c['name']}.json")
    return bench, layout, str(tmp_path / "work")


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CPU = {"platform": "cpu", "kind": "cpu", "count": 1}


def run_small(small_layout, workload, seed, trace=False, seconds=0.5):
    bench, layout, work = small_layout
    return run.run_cell(bench, workload, seed, seconds, trace, "cpu", CPU, here=layout, root=Path("/"),
                        workdir=work)
