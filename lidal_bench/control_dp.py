"""Readings that set ``sk_minkunet_train_dp4``'s limits (not run by the benchmark's runs).

    python3 -m lidal_bench.control_dp --seeds 1,2,3 [--tf32 1,2] [--faults no_grad_allreduce,no_bn_allreduce]
        [--fault-seeds 1,2] [--one-card]

For each seed of ``--seeds``, a run of the cell with a one-second window:
the program's readings (the lower ones).  For each seed of ``--tf32``, the
control: the reference over the same global batches computed with TF32 on
(the nearest precision below the configuration's f32 with TF32 off), put in
the program's place.  For each fault and each seed of ``--fault-seeds``, a
run with the fault planted in every rank (each must read ``correct`` false):

* ``no_grad_allreduce``: each rank steps on its own gradients, the sum over
  the group left out;
* ``no_bn_allreduce``: each BN's train-mode sums kept per rank.

``--one-card``: the ranks share card 0 over gloo.  Each rank runs the
kernels and shapes it runs on a card of its own; the sums over the group
run in gloo's order instead of NCCL's ring.  A seed's reference is computed
once and serves all its runs.  One JSON line per seed and kind.
"""

from __future__ import annotations

import argparse
import datetime
import contextlib
import json
import sys

import torch
import torch.distributed as dist

from lidal_bench import check, run
from lidal_bench.loops import train_dp

WORKLOAD = train_dp.CELL["name"]
FAULTS = ("no_grad_allreduce", "no_bn_allreduce")
GLOO_TIMEOUT = datetime.timedelta(minutes=3)  # a rank that died stops the readings this soon


def _gloo_join(rank: int, ranks: int, port: int, device: str) -> torch.device:
    """This rank in a gloo group; a CUDA rank on card 0."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=ranks,
                            timeout=GLOO_TIMEOUT)
    return dev


def plant(spec) -> list:
    """``spec`` = (fault or None, one card): the port's functions swapped in
    this process; returns ``(module, name, original)`` to restore."""
    from lidal_tpu_torch.models import layers
    from lidal_tpu_torch.runtime import train

    fault, one_card = spec
    saved = []

    def swap(mod, attr, new):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    if fault == "no_grad_allreduce":
        swap(train, "sum_gradients", lambda model, group: None)
    elif fault == "no_bn_allreduce":
        swap(layers, "all_reduce_sum", lambda t, group: t)
    elif fault is not None:
        raise ValueError(f"no fault {fault!r}")
    if one_card:
        swap(train_dp, "_join", _gloo_join)
    return saved


@contextlib.contextmanager
def planted(fault, one_card: bool = False):
    """The program with ``fault`` (None: as it is) in this process and in
    every rank ``train_dp`` spawns, on one card if ``one_card``."""
    saved = plant((fault, one_card))
    before = train_dp.RANK_HOOK
    train_dp.RANK_HOOK = (plant, (fault, one_card))
    try:
        yield
    finally:
        train_dp.RANK_HOOK = before
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="")
    ap.add_argument("--tf32", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--one-card", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = train_dp.with_cell(run.load_bench())
    info = run.card()
    seeds, tf32, fault_seeds = _seeds(args.seeds), set(_seeds(args.tf32)), _seeds(args.fault_seeds)
    faults = [f for f in args.faults.split(",") if f]
    refs = {}
    orig_ref = train_dp.reference_steps

    def reference_steps(rc, data_root, weights, dev, **kw):
        if rc.seed not in refs:
            refs[rc.seed] = orig_ref(rc, data_root, weights, dev, **kw)
            if rc.seed in tf32:
                low = orig_ref(rc, data_root, weights, dev, use_tf32=True)
                print(json.dumps({"seed": rc.seed, "kind": "control", "card": info.get("nvidia_smi"),
                                  "readings": check.train_readings(low, refs[rc.seed])}), flush=True)
        return refs[rc.seed]

    train_dp.reference_steps = reference_steps
    try:
        for seed in dict.fromkeys(seeds + fault_seeds):
            kinds = ([None] if seed in seeds else []) + (faults if seed in fault_seeds else [])
            for kind in kinds:
                with planted(kind, args.one_card):
                    out = run.run_cell(bench, WORKLOAD, seed, 1.0, False, "cuda", info)
                print(json.dumps({"seed": seed, "kind": kind or "program", "one_card": args.one_card,
                                  "correct": out["correct"], "card": info.get("nvidia_smi"),
                                  "readings": {r["name"]: r["value"] for r in out["checks"]},
                                  "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                                  "setup_s": out["metrics"]["setup_s"]["value"]}), flush=True)
                torch.cuda.empty_cache()
            refs.pop(seed, None)
    finally:
        train_dp.reference_steps = orig_ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
