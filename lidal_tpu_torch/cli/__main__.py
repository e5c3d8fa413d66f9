"""CLI: ``python -m lidal_tpu_torch.cli <command> [--flags]`` (port of
``lidal_tpu/cli/__main__.py``: the same subcommands and flags, plus ``--device``).

Mirrors the reference's per-script CLIs (``train.py:208-219``,
``evaluate.py:146-157``, ``score/prob_inference.py:230-243``,
``score/*/*.py`` mains) behind one typed entry point:

  train           one round of training
  evaluate        val-split mIoU for a trained round
  prob-inference  multi-view probability dump over the train split
  score           active selection for --metric_name (frame- or sv-level)
  prep            offline preprocessing: grids / supervoxels / vccs / boundary / bootstrap
  import-torch    convert a reference current.pt into this framework's checkpoint
  run-experiment  orchestrate full active-learning rounds

Every command that runs a model runs it on ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain versions); ``prep`` runs on the host.

``--bf16_route`` runs every model call of the command on the bf16 route: the
route the JAX package takes on its TPU (``lidal_tpu/ops/conv.py:USE_PALLAS``
and ``ops/pallas_gather8.py:USE_PALLAS_BWD``), operands staged in bf16 and
sums in f32, on the bf16 kernels (``ops/conv.bf16_route``).  Off by default:
without it every command runs the f32 kernels, on every device.

Under ``torchrun`` (``torchrun --nproc_per_node=N -m lidal_tpu_torch.cli
<command> ...``) every rank joins one process group first
(``parallel/mesh.init_from_env``): ``--device cuda`` becomes
``cuda:LOCAL_RANK``, and ``train``, ``evaluate``, ``prob-inference``,
``score``, ``fused-score`` and ``run-experiment`` run over the ranks; every
rank parses ``--bf16_route`` and takes the route itself.
``prep`` and ``import-torch`` join no group: rank 0 runs them alone and the
other ranks return at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch.distributed as dist

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.ops import conv
from lidal_tpu_torch.parallel import mesh


def _add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset_name", type=str, default="SK", help="SK | NU")
    p.add_argument("--model_name", type=str, default="Mink", help="contains Mink, SPVCNN or PTv3")
    p.add_argument("--label_unit", type=str, default="sv", help="fr | sv")
    p.add_argument("--metric_name", type=str, default="LiDAL")
    p.add_argument("--r_id", type=int, default=0)
    p.add_argument("--inf_reps", type=int, default=8)
    p.add_argument("--frames_per_dispatch", type=int, default=4,
                   help="kept for the reference CLI's sake: the port runs "
                        "prob-inference frame by frame (outputs are invariant)")
    p.add_argument("--reference_parity", action="store_true",
                   help="reproduce the reference's frame-level selections "
                        "verbatim, quirks included (see config.RunConfig)")
    p.add_argument("--no_fused_round", dest="fused_round", action="store_false",
                   default=True,
                   help="force the staged inference-then-score flow in "
                        "run-experiment instead of the fused single-pass "
                        "LiDAL rounds (outputs are bitwise identical)")
    p.add_argument("--max_iter", type=int, default=20000)
    p.add_argument("--data_root", type=str, default="Semantic_kitti/dataset/sequences")
    p.add_argument("--processing_root", type=str, default="Processing_files")
    p.add_argument("--checkpoint_root", type=str, default="check_points")
    p.add_argument("--batch_size", type=int, default=None, help="frames per batch")
    p.add_argument("--point_cap", type=int, default=None,
                   help="fixed per-frame point capacity")
    p.add_argument("--level_caps", type=str, default=None,
                   help="comma-separated voxel capacities per UNet level, e.g. 131072,49152,16384,6144,2048")
    p.add_argument("--train_seqs", type=str, default=None,
                   help="comma-separated sequence ids overriding the train split")
    p.add_argument("--val_seqs", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the command runs on (cuda | cuda:N | cpu)")
    p.add_argument("--bf16_route", action="store_true",
                   help="run every model call on the bf16 route, the JAX package's TPU route (operands "
                        "staged in bf16, f32 sums; lidal_tpu/ops/conv.py:USE_PALLAS); off: f32")


def _cfg(args) -> RunConfig:
    fields = {f.name for f in dataclasses.fields(RunConfig)}
    cfg = RunConfig(**{k: v for k, v in vars(args).items() if k in fields})
    overrides = {}
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.point_cap is not None:
        overrides["point_cap"] = args.point_cap
    if args.level_caps is not None:
        overrides["level_caps"] = tuple(int(c) for c in args.level_caps.split(","))
    if args.train_seqs is not None:
        overrides["train_split"] = tuple(args.train_seqs.split(","))
    if args.val_seqs is not None:
        overrides["val_split"] = tuple(args.val_seqs.split(","))
    if overrides:
        cfg = dataclasses.replace(cfg, data_override=dataclasses.replace(cfg.data, **overrides))
    return cfg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="lidal_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    for name in ("train", "evaluate", "prob-inference", "score", "fused-score"):
        p = sub.add_parser(name)
        _add_run_args(p)
    p = sub.add_parser("prep")
    _add_run_args(p)
    p.add_argument("--stage", type=str, required=True,
                   help="grids | supervoxels | vccs | boundary | bootstrap")
    p = sub.add_parser("import-torch")
    _add_run_args(p)
    p.add_argument("--pt_path", type=str, required=True,
                   help="path to a reference current.pt (README.md:88-92 release)")
    p = sub.add_parser("run-experiment")
    _add_run_args(p)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--no-eval", action="store_true")

    args = parser.parse_args(argv)
    cfg = _cfg(args)
    if args.command in ("prep", "import-torch"):
        if int(os.environ.get("RANK", "0")) == 0:  # host work: one process, no collective to wait in
            _run_host(args, cfg)
        return 0
    device = mesh.init_from_env(args.device)
    group = dist.group.WORLD if dist.is_initialized() else None
    try:
        with conv.bf16_route(args.bf16_route):
            _run(args, cfg, device, group)
    finally:
        if group is not None:
            dist.destroy_process_group()
    return 0


def _run(args, cfg: RunConfig, device, group) -> None:
    if args.command == "train":
        from lidal_tpu_torch.runtime.train_loop import run_train

        run_train(cfg, device=device, group=group)
    elif args.command == "evaluate":
        from lidal_tpu_torch.cli.commands import evaluate_command

        evaluate_command(cfg, device, group)
    elif args.command == "prob-inference":
        from lidal_tpu_torch.cli.commands import prob_inference_command

        prob_inference_command(cfg, device, group)
    elif args.command == "score":
        from lidal_tpu_torch.cli.commands import score_command

        score_command(cfg, device, group)
    elif args.command == "fused-score":
        from lidal_tpu_torch.cli.commands import fused_score_command

        fused_score_command(cfg, device, group)
    elif args.command == "run-experiment":
        from lidal_tpu_torch.runtime.round import run_experiment

        run_experiment(cfg, rounds=args.rounds, evaluate=not args.no_eval, device=device, group=group)


def _run_host(args, cfg: RunConfig) -> None:
    if args.command == "prep":
        from lidal_tpu_torch.cli.commands import prep_command

        prep_command(cfg, args.stage)
    else:
        from lidal_tpu_torch.cli.commands import import_torch_command

        import_torch_command(cfg, args.pt_path, args.device)


if __name__ == "__main__":
    sys.exit(main())
