"""The controls on the card at a small size: the reference computed with
TF32 on, put in the program's place, must not come out correct against
the cells' committed limits.  TF32 exists only on a card, so these skip
elsewhere (``-m cuda``)."""

from pathlib import Path

import pytest
import torch

from lidal_bench import check, control, run
from lidal_bench.loops import train as train_loop_mod


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 is a tensor-core mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**33 + 21, 2**33 + 22, 2**33 + 23])
@pytest.mark.parametrize("workload", ["sk_minkunet_train", "sk_minkunet_round"])
def test_tf32_control_is_not_correct(small_layout, card, workload, seed):
    bench, layout, work = small_layout
    _, rc, *_ = run.build_context(bench, workload, seed, 1.0, False, "cuda", here=layout, root=Path("/"),
                                  workdir=work)
    if rc.traffic["loop"] == "train":
        data_root, weights = train_loop_mod.make_inputs(rc, card)
        ref = train_loop_mod.reference_steps(rc, data_root, weights, card)
        readings = check.train_readings(train_loop_mod.reference_steps(rc, data_root, weights, card, use_tf32=True), ref)
    else:
        readings = dict(control.round_control(rc, card))["control"]
    lim = check.limits(run.HERE / "limits" / f"{workload}.json")
    assert any(readings[k] > lim[k] for k in readings), readings
