"""The bf16 route as a path of the port in its own right: the switch
(``lidal_tpu_torch/ops/conv.bf16_route``), the command line's ``--bf16_route``
on every model command (SemanticKITTI and nuScenes, MinkUNet and SPVCNN),
staged and fused rounds, and several ranks: where the JAX package takes its
Pallas route on its TPU (``lidal_tpu/ops/conv.USE_PALLAS``,
``ops/pallas_gather8.USE_PALLAS_BWD``).  On the CPU every routed call takes
its kernel's plain bf16 version.  ``tests/test_torch_bf16_route.py`` and
``tests/test_torch_bf16_route_models.py`` hold the route against the JAX
package's route; ``tests/test_torch_cuda.py`` the kernels against their
plain versions on the card.

Tolerances (each test states its own):
* the route against itself (staged against fused, a round or eval over two
  ranks against one process) and a command without the flag against the
  entry point it calls: bit-equal;
* a train step over two gloo ranks on the route against one process on the
  route: the tolerances of the route's step against the JAX route's (loss
  1e-3 relative, the gradients as one vector within ``GRAD_GLOBAL`` times
  the f32 route's distance, the classifier within 5e-2 of its norm), Adam's
  steps within 2 lr: on the route a reordered f32 sum ahead of a bf16
  rounding moves whole bf16 steps (see the test).
"""

import collections
import contextlib
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp_mp

from lidal_tpu_torch.active import lidal_runner
from lidal_tpu_torch.cli import __main__ as cli
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.ops import conv, cuda_conv, cuda_conv_bf16, cuda_conv_dxdw, cuda_conv_dxdw_fused, cuda_gather8
from lidal_tpu_torch.runtime import checkpoint as ckpt, evaluate
from lidal_tpu_torch.runtime.paths import Paths
from lidal_tpu_torch.runtime.prob_inference import run_prob_inference
from lidal_tpu_torch.runtime.train import TrainState, make_optimizer
from lidal_tpu_torch.runtime.train_loop import run_train
from tests import test_torch_parallel as par
from tests.synth import make_mini_sk
from tests.test_torch_bf16_route import GRAD_GLOBAL
from tests.test_torch_minkunet import NARROW
from tests.test_torch_nu_round import FRAMES as NU_FRAMES, prepared  # noqa: F401  (fixture)
from tests.test_torch_nuscenes import SCENES
from tests.test_torch_prep_native import native_build_dir  # noqa: F401  (fixture of `prepared`)

MODELS = ("Mink", "SPVCNN")
WORLD = 2


# ---- the switch -----------------------------------------------------------------------------------


def test_bf16_route_sets_both_switches_and_restores_them():
    """The route's one switch (which stands for both of the JAX package's
    flags), back to what it was on exit, also after an exception and when
    nested (``on=False`` inside the route turns it off for its block alone)."""
    assert conv.BF16_OPERANDS is False
    with conv.bf16_route():
        assert conv.BF16_OPERANDS is True
        with conv.bf16_route(False):
            assert conv.BF16_OPERANDS is False
        assert conv.BF16_OPERANDS is True
        with conv.bf16_route(True):
            assert conv.BF16_OPERANDS is True
        assert conv.BF16_OPERANDS is True
    assert conv.BF16_OPERANDS is False
    with pytest.raises(RuntimeError, match="inside"):
        with conv.bf16_route():
            with conv.bf16_route(False):
                raise RuntimeError("inside")
    assert conv.BF16_OPERANDS is False
    with pytest.raises(RuntimeError, match="inside"):
        with conv.bf16_route():
            raise RuntimeError("inside")
    assert conv.BF16_OPERANDS is False
    with conv.bf16_route(False):
        assert conv.BF16_OPERANDS is False
    assert conv.BF16_OPERANDS is False


# ---- every wrapper call on a path, by route --------------------------------------------------------

_F32_CONVS = ((cuda_conv, "subm_conv"), (cuda_conv_dxdw, "conv_dx_dw"))
_BF16_CONVS = ((cuda_conv_bf16, "conv_gather_first"), (cuda_conv_dxdw_fused, "conv_dx_dw_fused"))
_POINT_TRANSFERS = (("gather8_forward", 3, "bf16_table"), ("child_sum", 3, "bf16"), ("scatter8", 4, "bf16"))


@contextlib.contextmanager
def wrapper_calls(route: bool):
    """Within, a Counter of the conv wrappers' calls and of SPVCNN's point
    transfers (``gather8_forward``, ``child_sum``, ``scatter8``); a conv
    wrapper of the other route, or a point transfer called with the other
    route's flag, raises."""
    calls = collections.Counter()

    def refuse(name):
        def call(*a, **kw):
            raise AssertionError(f"{name} ran on the {'bf16' if route else 'f32'} route")

        return call

    def count(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)

        return call

    def flagged(name, fn, pos, kw_name):
        def call(*a, **kw):
            on = bool(a[pos]) if len(a) > pos else bool(kw.get(kw_name, False))
            if on != route:
                raise AssertionError(f"{name} called with {kw_name}={on} on the {'bf16' if route else 'f32'} route")
            calls[name] += 1
            return fn(*a, **kw)

        return call

    used, other = (_BF16_CONVS, _F32_CONVS) if route else (_F32_CONVS, _BF16_CONVS)
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in used:
            mp.setattr(mod, name, count(name, getattr(mod, name)))
        for mod, name in other:
            mp.setattr(mod, name, refuse(name))
        for name, pos, kw_name in _POINT_TRANSFERS:
            mp.setattr(cuda_gather8, name, flagged(name, getattr(cuda_gather8, name), pos, kw_name))
        yield calls


def _main(argv, route):
    """``cli.main(argv)`` (plus ``--bf16_route`` when ``route``), its wrapper
    calls; the switch is off again after it."""
    with wrapper_calls(route) as calls:
        assert cli.main(argv + (["--bf16_route"] if route else [])) == 0
    assert conv.BF16_OPERANDS is False
    return dict(calls)


# ---- the command line -----------------------------------------------------------------------------

SK_FRAMES = 60  # round(0.01 * 60) = 1 frame per round, as tests/test_torch_cli.py's


def _sk_common(r_id):
    return ["--dataset_name", "SK", "--model_name", "Mink", "--data_root", "sequences", "--processing_root",
            "Processing_files", "--checkpoint_root", "check_points", "--train_seqs", "00", "--val_seqs", "00",
            "--batch_size", "2", "--point_cap", "256", "--level_caps", "256,128,64,32,16", "--label_unit", "fr",
            "--metric_name", "ENT", "--inf_reps", "1", "--device", "cpu", "--r_id", str(r_id)]


def test_cli_sk_commands_on_the_route_and_off_it(tmp_path, monkeypatch):
    """On ``tests/test_torch_cli.py``'s SemanticKITTI mini tree: ``train``,
    ``prob-inference``, ``evaluate`` and ``score`` (ENT, frame level) with
    ``--bf16_route`` call only the bf16 wrappers, and without it only the
    f32 ones; without the flag the trained weights are bit-equal to
    ``run_train``'s on the same tree (the f32 route), with it they differ and
    so do the prob maps; the switch is off after every command, also
    after one that raised."""
    base = tmp_path / "base"
    make_mini_sk(str(base), seqs=("00",), frames_per_seq=SK_FRAMES, points=200)
    monkeypatch.chdir(base)
    for stage in ("grids", "bootstrap"):
        assert cli.main(["prep", "--stage", stage] + _sk_common(0)) == 0
    for tree in ("f32", "bf16", "direct"):
        shutil.copytree(base, tmp_path / tree)
    parser = cli.argparse.ArgumentParser()
    cli._add_run_args(parser)
    cfg0 = cli._cfg(parser.parse_args(_sk_common(0)))
    paths0 = Paths(cfg0)

    results = {}
    for route in (False, True):
        monkeypatch.chdir(tmp_path / ("bf16" if route else "f32"))
        with pytest.raises(FileNotFoundError):  # no checkpoint yet: the command raises, the switch is restored
            _main(["evaluate"] + _sk_common(0), route)
        assert conv.BF16_OPERANDS is False
        calls = {cmd: _main([cmd] + (["--max_iter", "1"] if cmd == "train" else []) + _sk_common(0), route)
                 for cmd in ("train", "prob-inference", "evaluate")}
        calls["score"] = _main(["score"] + _sk_common(1), route)
        fwd, bwd = ("conv_gather_first", "conv_dx_dw_fused") if route else ("subm_conv", "conv_dx_dw")
        assert calls["train"][fwd] > 0 and calls["train"][bwd] > 0, calls
        assert calls["prob-inference"][fwd] > 0 and calls["evaluate"][fwd] > 0, calls
        assert not calls["score"], calls  # ENT scores stored prob maps: no model call
        weights = torch.load(ckpt.ckpt_path(paths0.ckpt_dir()), weights_only=True)["model_state"]
        probs = {n: np.load(os.path.join(paths0.prob_dir("00"), n)) for n in sorted(os.listdir(paths0.prob_dir("00")))}
        flags = np.load(os.path.join(Paths(dataclasses.replace(cfg0, r_id=1)).frame_flag_dir(), "00.npy"))
        assert len(probs) == SK_FRAMES and flags.sum() == 2
        results[route] = weights, probs

    monkeypatch.chdir(tmp_path / "direct")
    direct = run_train(cfg0, max_iter=1, device="cpu").model.state_dict()
    (w_f32, p_f32), (w_bf16, p_bf16) = results[False], results[True]
    assert sorted(w_f32) == sorted(direct) == sorted(w_bf16)
    for k, v in direct.items():
        assert torch.equal(w_f32[k], v), k
    assert any(not torch.equal(w_bf16[k], v) for k, v in direct.items() if v.is_floating_point())
    assert any(not np.array_equal(p_bf16[n], p) for n, p in p_f32.items())


def test_cli_nu_spvcnn_round_on_the_route(prepared, tmp_path, monkeypatch):  # noqa: F811
    """``tests/test_torch_cli.py``'s nuScenes round through the command line
    with SPVCNN and ``--bf16_route`` on every command: prep -> train (r0) ->
    prob-inference -> score (LiDAL, staged) -> train (r1) -> evaluate ->
    fused-score (r2), beside a staged r2 round (prob-inference (r1) -> score)
    -> run-experiment (2 rounds, the second fused).  Every
    model command calls only the bf16 conv wrappers and the point transfers
    on their bf16 rows, the training ones ``conv_dx_dw_fused`` and
    ``scatter8`` too; the staged and the fused round from the same r1
    weights write the same r2 flags."""
    root, _ = prepared
    shutil.copytree(root, tmp_path / "nuScenes", ignore=shutil.ignore_patterns("Processing_files"))
    with open(tmp_path / "nuScenes" / "splits.json", "w") as f:
        json.dump({"train": [SCENES[0]], "val": [SCENES[1]]}, f)
    monkeypatch.chdir(tmp_path)
    scene = SCENES[0]
    common = ["--dataset_name", "NU", "--model_name", "SPVCNN", "--train_seqs", scene, "--batch_size", "2",
              "--point_cap", "1024", "--level_caps", "1024,1024,512,256,64", "--inf_reps", "1", "--max_iter", "1",
              "--device", "cpu"]
    parser = cli.argparse.ArgumentParser()
    cli._add_run_args(parser)
    cfg = cli._cfg(parser.parse_args(common))
    for stage in ("grids", "supervoxels", "bootstrap"):  # host stages: the flag changes nothing there
        assert _main(["prep", "--stage", stage] + common, True) == {}
    paths = Paths(cfg)
    np.save(os.path.join(paths.frame_flag_dir(r_id=0), f"{scene}.npy"), np.arange(NU_FRAMES) < 2)
    svdir = paths.sv_flag_dir(scene, r_id=0)
    for i, name in enumerate(sorted(os.listdir(svdir))):
        np.save(os.path.join(svdir, name), np.full(len(np.load(os.path.join(svdir, name))), int(i < 2), np.int32))

    fr = ["--label_unit", "fr"]
    calls = {
        "train r0": _main(["train", "--r_id", "0"] + fr + common, True),
        "prob-inference r0": _main(["prob-inference", "--r_id", "0"] + fr + common, True),
        "score r1": _main(["score", "--r_id", "1"] + common, True),
        "train r1": _main(["train", "--r_id", "1"] + common, True),
        "evaluate r1": _main(["evaluate", "--r_id", "1"] + common, True),
    }
    shutil.copytree(tmp_path / "Processing_files", tmp_path / "staged")
    staged = ["--processing_root", "staged"]
    calls["prob-inference r1"] = _main(["prob-inference", "--r_id", "1"] + staged + common, True)
    assert _main(["score", "--r_id", "2"] + staged + common, True) == {}
    calls["fused-score r2"] = _main(["fused-score", "--r_id", "2"] + common, True)
    r2, r2_staged = (Paths(dataclasses.replace(cfg, r_id=2, processing_root=root)) for root in ("Processing_files",
                                                                                                   "staged"))
    names = sorted(os.listdir(r2.sv_flag_dir(scene)))
    assert len(names) == NU_FRAMES and names == sorted(os.listdir(r2_staged.sv_flag_dir(scene)))
    for name in names:
        np.testing.assert_array_equal(np.load(os.path.join(r2.sv_flag_dir(scene), name)),
                                      np.load(os.path.join(r2_staged.sv_flag_dir(scene), name)), err_msg=name)
    # each round resumes its checkpoint of step 1 and trains to step 2
    calls["run-experiment"] = _main(["run-experiment", "--rounds", "2", "--no-eval"] + common + ["--max_iter", "2"],
                                    True)
    for what, c in calls.items():
        if what == "score r1":
            assert not c, c  # LiDAL scoring reads stored prob maps: no model call
            continue
        want = {"conv_gather_first", "gather8_forward", "child_sum"}
        if what.startswith("train") or what == "run-experiment":
            want |= {"conv_dx_dw_fused", "scatter8"}
        assert want <= {k for k, v in c.items() if v}, (what, c)



# ---- rounds on the route: staged == fused, MinkUNet and SPVCNN -------------------------------------


def _round_model(family):
    """A seeded narrow model of ``family`` in eval mode (SPVCNN without dropout)."""
    torch.manual_seed(5)
    model = MinkUNet(19, cs=NARROW) if family == "Mink" else SPVCNN(19, cs=NARROW, dropout_rate=0.0)
    return model.eval()


def _round_tree(root, family):
    """``tests/test_torch_parallel.py``'s r_id = 2 scoring tree (28 frames of
    one static world, frame 0 labelled in round 1) for ``family``."""
    cfg = par._write_round_tree(root)
    if family == "Mink":
        return cfg
    spv = dataclasses.replace(cfg, model_name="SPVCNN")  # the flags of a round live under its model's name
    shutil.copytree(Paths(dataclasses.replace(cfg, r_id=1)).sv_flag_dir(par.SEQ),
                    Paths(dataclasses.replace(spv, r_id=1)).sv_flag_dir(par.SEQ))
    return spv


def _route_round(root, family, fused, group=None):
    """One LiDAL round of ``family`` on the route over the tree under
    ``root``: (the config, (selection, the arrays the selection saw), the
    wrapper calls)."""
    names, read, fid, read_raw = par._round_io()
    cfg = par._round_cfg(root) if family == "Mink" else dataclasses.replace(par._round_cfg(root), model_name="SPVCNN")
    with wrapper_calls(True) as calls, conv.bf16_route():
        if fused:
            res = par._scored(lidal_runner.run_fused_lidal_round, cfg, _round_model(family), read_raw, device="cpu",
                              group=group)
        else:
            run_prob_inference(lidal_runner._prev_cfg(cfg), _round_model(family), names, read, fid, device="cpu")
            res = par._scored(lidal_runner.run_lidal_round, cfg, device="cpu", group=group)
    return cfg, res, dict(calls)


@pytest.fixture(scope="module")
def single_rounds(tmp_path_factory):
    """{(family, fused): _route_round(...)} in this process, each on its own tree."""
    root = tmp_path_factory.mktemp("route_rounds")
    out = {}
    for family in MODELS:
        for fused in (False, True):
            tree = str(root / f"{family}_{'fused' if fused else 'staged'}")
            _round_tree(tree, family)
            out[family, fused] = _route_round(tree, family, fused)
    return out


def _assert_rounds_equal(cfg_a, res_a, cfg_b, res_b):
    """Selections, the arrays they saw, flags and prob / pred maps bit-equal."""
    (sel_a, seen_a), (sel_b, seen_b) = res_a, res_b
    for a, b in zip(seen_a, seen_b):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(sel_a, sel_b):
        np.testing.assert_array_equal(a, b)
    flags_a, flags_b = par._flags(cfg_a), par._flags(cfg_b)
    assert sorted(flags_a) == sorted(flags_b) and len(flags_a) == par.ROUND_FRAMES
    for k, v in flags_a.items():
        np.testing.assert_array_equal(flags_b[k], v, err_msg=str(k))
    maps_a, maps_b = par._maps(cfg_a), par._maps(cfg_b)
    assert set(maps_a) == set(maps_b) and len(maps_a) == 2 * par.ROUND_FRAMES
    for k, v in maps_a.items():
        np.testing.assert_array_equal(maps_b[k], v, err_msg=str(k))


@pytest.mark.parametrize("family", MODELS)
def test_staged_round_equals_fused_round_on_the_route(single_rounds, family):
    """On the route, inference then scoring (staged) and the fused round see
    bit-equal supervoxel scores and select the same supervoxels, and write
    the same flags and prob / pred maps; every model call took the bf16
    wrappers (SPVCNN's point transfers on bf16 rows)."""
    cfg_s, res_s, calls_s = single_rounds[family, False]
    cfg_f, res_f, calls_f = single_rounds[family, True]
    sel = res_f[0]
    assert len(sel[1]) > 0 and (sel[0] == 2).any()  # supervoxels for labels and for pseudo labels
    _assert_rounds_equal(cfg_s, res_s, cfg_f, res_f)
    for calls in (calls_s, calls_f):
        assert calls["conv_gather_first"] > 0 and calls.get("conv_dx_dw_fused", 0) == 0, calls
        assert calls.get("gather8_forward", 0) == calls.get("child_sum", 0) == (
            calls["conv_gather_first"] // 21 if family == "SPVCNN" else 0), calls  # 2 each per 42-conv forward


# ---- several ranks on the route --------------------------------------------------------------------


def _route_step(name, tb, group=None, route=True):
    """One train step of a seeded narrow ``name`` (sync-BN over ``group``) on
    ``tb``: (loss, {parameter: its gradient summed over the group}, the
    state after Adam)."""
    torch.manual_seed(7)
    model = par._narrow(name, group)
    state = TrainState(0, model, make_optimizer(model))
    with conv.bf16_route(route):
        loss = par._steps(state, tb, group, n=1)[0]
    return loss, {n: p.grad.clone() for n, p in model.named_parameters()}, model.state_dict()


def _route_rank_main(rank, init_file, root):
    """One rank of a gloo group on the route: the sharded train step of each
    model (2 steps on this rank's frame), eval of 10 frames in global
    batches of 4, and the fused round of each model over the group;
    results under ``root``."""
    out = {"inherited": conv.BF16_OPERANDS}  # a spawned process starts from the modules' defaults
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=WORLD)
    group = dist.group.WORLD
    try:
        with wrapper_calls(True) as calls, conv.bf16_route():
            out["switch"] = conv.BF16_OPERANDS
            for name in MODELS:
                out[f"step_{name}"] = _route_step(name, par._train_batch(name, slice(rank, rank + 1)), group)
            res = evaluate.run_eval(par._cfg(root), par._round_model(), par._loader(10, 4, 3), "cpu",
                                    torch.Generator().manual_seed(4), group=group)
            out["eval"] = (res.confusion, res.overflow, res.points, res.miou)
        out["calls"] = dict(calls)
        for family in MODELS:
            out[f"fused_{family}"] = _route_round(os.path.join(root, f"fused_{family}"), family, True, group)[1:]
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


@pytest.fixture(scope="module", autouse=True)
def route_ranks_started(tmp_path_factory):
    """Two gloo ranks spawned at the module's start (they work while the
    tests before theirs run), joined at its end at the latest."""
    root = str(tmp_path_factory.mktemp("route_ranks"))
    for family in MODELS:
        _round_tree(os.path.join(root, f"fused_{family}"), family)
    with conv.bf16_route():  # on here: the ranks still have to turn it on themselves
        procs = tmp_mp.start_processes(_route_rank_main, args=(os.path.join(root, "init"), root), nprocs=WORLD,
                                       join=False, start_method="spawn")
    try:
        yield root, procs
    finally:
        while not procs.join():
            pass


@pytest.fixture(scope="module")
def route_ranks(route_ranks_started):
    root, procs = route_ranks_started
    while not procs.join():
        pass
    return root, [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]


def test_spawned_ranks_turn_the_route_on_themselves(route_ranks):
    """A spawned rank inherits no module global (its parent spawned it on the
    route): each rank starts off the route and takes it through
    ``bf16_route``, and its model calls ran on the bf16 wrappers alone."""
    _, ranks = route_ranks
    for r in ranks:
        assert r["inherited"] is False and r["switch"] is True
        calls = r["calls"]
        assert calls["conv_gather_first"] > 0 and calls["conv_dx_dw_fused"] > 0, calls
        assert calls["gather8_forward"] > 0 and calls["child_sum"] > 0 and calls["scatter8"] > 0, calls


@pytest.mark.parametrize("name", MODELS)
def test_sharded_train_step_on_the_route_equals_one_process(route_ranks, name):
    """One step over 2 ranks on the route (one frame each, sync-BN and the
    gradient sum over the group) against one step of one process on the
    route over both frames, from the same seeded weights.

    On the route the f32 tolerances of ``tests/test_torch_parallel.py`` do
    not apply: any change in the order of an f32 sum ahead of a bf16
    rounding (here sync-BN's sums over two ranks) moves the few operands
    that lie near a rounding boundary by a bf16 step, and at a narrow
    network's random start BN cancels most of each gradient (see
    ``tests/test_torch_bf16_route.py``).  Measured on these frames: swapping
    the two frames of one process's batch moves the first loss by 1.2e-5 /
    3.7e-5 relative (MinkUNet / SPVCNN) on the route and by 0 on the f32
    route.  So the step is held as ``tests/test_torch_bf16_route.py`` holds
    the route's step to the JAX route's: the loss within 1e-3 relative, the
    summed gradients (as one vector) no further from one process's than
    ``GRAD_GLOBAL`` times the f32 route's gradients are, the classifier's
    within 5e-2 of its norm; after Adam every weight within 2 lr of one
    process's (``tests/test_torch_parallel.py``'s bound: a fresh Adam's
    first step is +-lr where a gradient's sign flips; plus the weights' own
    f32 rounding, as a BN weight near 1 moved by 2 lr is); the two ranks hold
    bit-equal weights and gradients.  Each parameter apart is not held to
    the f32 route's distance (``GRAD_EACH``): against a perturbation of
    this kind, a parameter whose f32 distance is small by chance went past
    4x it (``up3.1.1.net.1.weight``: 6.3e-3 against 1.4e-3)."""
    _, ranks = route_ranks
    tb = par._train_batch(name, slice(0, 2))
    loss, grads, single = _route_step(name, tb)
    _, grads_f32, _ = _route_step(name, tb, route=False)
    assert grads_f32.keys() == grads.keys()
    norm = {n: float(g.norm()) for n, g in grads.items()}
    names = [n for n in grads if norm[n] > 0]  # a Linear bias ahead of a BN: 0 by construction
    dist_f32 = {n: float((grads_f32[n] - grads[n]).norm()) for n in names}
    total_f32 = float(np.sqrt(sum(d ** 2 for d in dist_f32.values())))
    ranks_step = [res[f"step_{name}"] for res in ranks]
    for r, (got_loss, got_grads, got) in enumerate(ranks_step):
        np.testing.assert_allclose(got_loss, loss, rtol=1e-3, err_msg=f"rank {r}")
        dist_ = {n: float((got_grads[n] - grads[n]).norm()) for n in names}
        total = float(np.sqrt(sum(d ** 2 for d in dist_.values())))
        print(f"{name} rank {r}: loss {got_loss:.6f} against {loss:.6f}; gradients {total:.3e} from one process's "
              f"(the f32 route {total_f32:.3e}), the classifier's weight "
              f"{dist_['classifier.0.weight'] / norm['classifier.0.weight']:.2e} of its norm")
        assert total <= GRAD_GLOBAL * total_f32, f"rank {r}: gradients {total:.3e}, the f32 route {total_f32:.3e}"
        for n in ("classifier.0.weight", "classifier.0.bias"):
            assert dist_[n] <= 5e-2 * norm[n], f"rank {r}, {n}: {dist_[n] / norm[n]:.3e} of its norm"
        for k, w in single.items():
            if "running" not in k:
                # a fresh Adam's first step is +-lr where a gradient's sign flipped, plus each weight's rounding
                bound = 2 * par.LR + 2 * torch.finfo(torch.float32).eps * w.abs()
                assert bool(((got[k] - w).abs() <= bound).all()), f"rank {r}: {k}"
    (_, g0, s0), (_, g1, s1) = ranks_step
    assert all(torch.equal(g0[n], g1[n]) for n in g0) and all(torch.equal(s0[k], s1[k]) for k in s0)


def test_sharded_eval_on_the_route_equals_one_process(route_ranks):
    """Eval of 10 frames in global batches of 4 (the last padded) over 2
    ranks on the route: confusion, overflow, points and mIoU equal to one
    process on the route."""
    _, ranks = route_ranks
    with conv.bf16_route():
        res = evaluate.run_eval(par._cfg("unused"), par._round_model(), par._loader(10, 4, 3), "cpu",
                                torch.Generator().manual_seed(4))
    assert res.overflow.sum() > 0 and res.points == int(par._points(10, 3)[2].sum())
    for r in ranks:
        conf, overflow, points, miou = r["eval"]
        np.testing.assert_array_equal(conf, res.confusion)
        np.testing.assert_array_equal(overflow, res.overflow)
        assert points == res.points and miou == res.miou


@pytest.mark.parametrize("family", MODELS)
def test_fused_round_over_ranks_on_the_route_equals_one_process(route_ranks, single_rounds, family):
    """The fused round of each model over 2 ranks on the route (rank 1's ring
    starts mid-sequence) sees bit-equal scores, selects the same supervoxels
    and writes the same flags and prob / pred maps as one process on the
    route."""
    root, ranks = route_ranks
    cfg1, res1, _ = single_rounds[family, True]
    cfg_g = par._round_cfg(os.path.join(root, f"fused_{family}"))
    if family == "SPVCNN":
        cfg_g = dataclasses.replace(cfg_g, model_name="SPVCNN")
    for r in ranks:
        res_r, calls = r[f"fused_{family}"]
        assert calls["conv_gather_first"] > 0, calls
        _assert_rounds_equal(cfg1, res1, cfg_g, res_r)
