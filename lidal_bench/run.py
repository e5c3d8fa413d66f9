"""Run one cell of the benchmark once.

    python3 -m lidal_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic and
its metrics are found by name from ``BENCHMARK.json``: the configuration in
its ``file``, the traffic in ``lidal_bench/traffic/<traffic>.json`` (whose
``loop`` names a module of ``lidal_bench/loops``), each per-layer
metric's reader in ``lidal_bench/metrics/<metric>.py`` and the check's
limits in ``lidal_bench/limits/<workload>.json``.  A later cell, traffic
mix or metric is a file and an entry, with no edit here.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the comparisons are also the last lines of standard error.  The
run exits non-zero, printing no result, without the cards the cell needs
or when ``jax``, ``jaxlib``, ``flax`` or ``lidal_tpu`` was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lidal_tpu")


def _process_age() -> Callable[[], float]:
    """Seconds since this process started (its start time in /proc), or since
    this module was imported where /proc is missing."""
    t_import = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        hz = os.sysconf("SC_CLK_TCK")

        def age() -> float:
            with open("/proc/uptime") as f:
                return float(f.read().split()[0]) - start_ticks / hz
        age()
        return age
    except (OSError, ValueError, IndexError):
        return lambda: time.monotonic() - t_import


SINCE_START = _process_age()


def forbidden_modules(names) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole: ``lidal_tpu_torch`` is not
    ``lidal_tpu``."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


@dataclass
class RunContext:
    workload: str
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    workdir: str
    instruments: List = field(default_factory=list)
    since_start: Callable[[], float] = SINCE_START


def load_bench(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, workload: str):
    """(end-to-end metrics, per-layer metrics) that ``workload`` reports."""
    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"] if applies(m) and m["moves"] in names]
    return e2e, layers


def readers(per_layer: List[Dict], here: Path = HERE) -> Dict:
    return {m["name"]: _load_file(here / "metrics" / f"{m['name']}.py", f"lidal_bench_metric_{i}")
            for i, m in enumerate(per_layer)}


def build_context(bench: Dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
                  here: Path = HERE, root: Path = ROOT, workdir: Optional[str] = None):
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(here / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    e2e, per_layer = cell_metrics(bench, workload)
    rd = readers(per_layer, here) if trace else {}
    instruments = [(name, *spec) for name, mod in rd.items() for spec in getattr(mod, "INSTRUMENT", ())]
    workdir = workdir or os.path.join(tempfile.gettempdir(), "lidal_bench", workload)
    rc = RunContext(workload, config, traffic, seed, seconds, trace, device, workdir, instruments)
    return cell, rc, e2e, per_layer, rd


def card() -> Dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        out["nvidia_smi"] = q.stdout.strip().splitlines()[0] if q.stdout.strip() else q.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"not read: {e}"
    return out


def assemble(bench, workload, rc, e2e, per_layer, rd, res, dev_info, here: Path = HERE) -> Dict:
    """The result line of one run (and the check's rows)."""
    from lidal_bench import check

    path = here / "limits" / f"{workload}.json"
    lim = check.limits(path) if path.exists() else {}
    ok, rows = check.judge(res["readings"], lim)
    ok = ok and bool(lim) and res["failed"] == 0
    metrics = {}
    if rc.trace:
        rec = res["record"]
        for m in per_layer:
            v = rd[m["name"]].read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": res["e2e"][m["name"]], "unit": m["unit"]}
    device = {"platform": dev_info["platform"], "kind": dev_info["kind"], "count": dev_info["count"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": ok, "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
           "device": device}
    if rc.trace:
        prof = res["record"]["profile"] or {}
        device["busy_s"], device["window_s"] = prof.get("busy_s", 0.0), prof.get("window_s", 0.0)
        out["breakdown"] = {"device_ops": prof.get("device_ops", []), "idle_gaps": prof.get("idle_gaps", [])}
    out["card"] = dev_info.get("nvidia_smi", "")
    out["checks"] = rows
    return out


def run_cell(bench, workload, seed, seconds, trace, device, dev_info, here: Path = HERE, root: Path = ROOT,
             workdir: Optional[str] = None) -> Dict:
    """Everything of a run but the look for a card; returns the result line."""
    cell, rc, e2e, per_layer, rd = build_context(bench, workload, seed, seconds, trace, device, here, root, workdir)
    loop = importlib.import_module(f"lidal_bench.loops.{rc.traffic['loop']}")
    res = loop.run(rc)
    for lv in res["levels"]:
        print(f"[levels] {lv['what']}: voxels per level {list(lv['voxels'])}, overflow per level "
              f"{lv['overflow']} (caps {list(rc.config['level_caps'])})", file=sys.stderr)
    return assemble(bench, workload, rc, e2e, per_layer, rd, res, dev_info, here)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    dev_info = card()
    from lidal_tpu_torch import kernels_build

    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", dev_info)
    print("[build] " + json.dumps({k: v[0] for k, v in kernels_build.BUILD_LOG.items()}), file=sys.stderr)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for row in out["checks"]:
        print(f"[check] {row['name']} = {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
