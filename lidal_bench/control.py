"""Readings that set the check's limits (not run by the benchmark's runs).

    python3 -m lidal_bench.control --workload <train cell> --seeds 1,2,3 [--program]

For each seed, on the card, at the cell's own sizes and inputs:

* ``control``: the reference computed with TF32 on (the nearest precision
  below the configuration's f32 with TF32 off), put in the program's place
  and compared with the f32 reference (a round cell: the sampled frames'
  probabilities and scores; and as a fault, ``next_frame_neighbours``,
  their scores against the next frame's neighbours);
* ``half_batch``: the reference with each step's loss over half of the
  batch's frames, compared the same way (a fault the check must catch);
* with ``--program``: a run of the cell with a one-second window, whose
  readings are the program's own (the lower readings).

A step that returns its state unchanged reads 1 on ``delta_gap`` by
construction and needs no run.  One JSON line per seed and kind.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from lidal_bench import check, run


def round_control(rc, dev) -> list:
    """Over the frames the check samples: the reference computed with TF32 on,
    its probabilities and the first frame's scores (from its own
    probabilities of the frame's neighbours), against the f32 reference's
    (``control``); and as a fault, that frame scored against the next
    frame's neighbours (a ring that hands out the wrong slots) against the
    right ones."""
    from lidal_bench.loops import round as round_loop
    from lidal_bench.reference import round as rround

    n = rc.traffic["frames"]
    _, frames, registered, point2sv, weights, _ = round_loop.make_inputs(rc, dev)
    f32 = round_loop.ReferenceFrames(rc, frames, weights, dev)
    low = round_loop.ReferenceFrames(rc, frames, weights, dev, use_tf32=True)
    control = {"prob_gap": 0.0, "score_gap": 0.0}
    fault = {"score_gap": 0.0}
    sample = round_loop.sampled_frames(rc)
    control["prob_gap"] = max(float(abs(low(fi) - f32(fi)).max()) for fi in sample)
    fi = sample[0]
    shifted = f32.sv_scores(fi, registered, point2sv, rround.neighbor_ids(min(fi + 1, n - 1), n))
    for want, lowered, bad in zip(f32.sv_scores(fi, registered, point2sv), low.sv_scores(fi, registered, point2sv),
                                  shifted):
        control["score_gap"] = max(control["score_gap"], round_loop.rel_gap(lowered, want))
        fault["score_gap"] = max(fault["score_gap"], round_loop.rel_gap(bad, want))
    return [("control", control), ("next_frame_neighbours", fault)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from lidal_bench.loops import train as train_loop_mod

    bench = run.load_bench()
    dev = torch.device("cuda")
    info = run.card()
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            out = run.run_cell(bench, args.workload, seed, 1.0, False, "cuda", info)
            print(json.dumps({"seed": seed, "kind": "program", "correct": out["correct"],
                              "readings": {r["name"]: r["value"] for r in out["checks"]},
                              "setup_s": out["metrics"]["setup_s"]["value"]}), flush=True)
        if args.no_control:
            continue
        _, rc, *_ = run.build_context(bench, args.workload, seed, 1.0, False, "cuda")
        if rc.traffic["loop"] == "round":
            for kind, readings in round_control(rc, dev):
                print(json.dumps({"seed": seed, "kind": kind, "card": info.get("nvidia_smi"),
                                  "readings": readings}), flush=True)
            torch.cuda.empty_cache()
            continue
        data_root, weights = train_loop_mod.make_inputs(rc, dev)
        ref = train_loop_mod.reference_steps(rc, data_root, weights, dev)
        for kind, kw in (("control", {"use_tf32": True}), ("half_batch", {"fault": "half_batch"})):
            other = train_loop_mod.reference_steps(rc, data_root, weights, dev, **kw)
            print(json.dumps({"seed": seed, "kind": kind, "card": info.get("nvidia_smi"),
                              "readings": check.train_readings(other, ref)}), flush=True)
        del weights, ref, other
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
