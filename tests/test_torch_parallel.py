"""The port's multi-device path (``lidal_tpu_torch/parallel/mesh.py`` and the
``group`` argument of the entry points) against one process,
after ``tests/test_parallel_drivers.py``, whose ``n_devices > 1`` cases are
slow JAX compiles and stay out of tier-1.

Two ranks of a gloo group on the CPU are spawned once (``torch.multiprocessing``,
``init_method=file://`` under a temporary directory); each runs every sharded
case and saves what it found, and the tests below hold it against the same
work done by this process alone (the JAX references are computed here while
the ranks run).  Frames: rings of 0.9 P points at P = 2048 with caps (2048,
1024, 512, 256, 128) as in ``test_parallel_drivers.py`` (levels 3-4
overflow), narrow models; the train step against JAX on the frames and caps
of ``test_torch_train.py`` and ``test_torch_spvcnn.py``, one frame a rank.

Tolerances (f32 sums of the same terms in another order):
* loss: 1e-5 relative; BN running statistics 2e-4 relative + 2e-6 (as
  ``test_parallel_drivers.py``), against JAX 1e-5 + 1e-5 (as
  ``test_torch_train.py``);
* parameters after Adam: every entry within 2 * lr and all but 1e-3 of them
  within 1e-2 * lr (Adam turns the rounding noise of a near-zero gradient
  into a step of up to lr either way; ``test_torch_train.py``);
* sync-BN over unequal valid counts: output, statistics and gradients within
  1e-6 of the largest entry;
* everything integer (confusion, overflow, selections, flags) and every prob
  map: exactly equal; a group of one rank: bit-equal to no group.
"""

import dataclasses
import datetime
import functools
import os
import shutil
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp_mp

from lidal_tpu_torch.active import lidal_runner
from lidal_tpu_torch.cli import __main__ as cli, commands
from lidal_tpu_torch.config import SK_CONFIG, RunConfig
from lidal_tpu_torch.data.loader import FrameBatchLoader
from lidal_tpu_torch.data.pipeline import prepare_train_batch
from lidal_tpu_torch.data.selection import save_sv_info
from lidal_tpu_torch.models.layers import MaskedBatchNorm, sync_batchnorm
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.parallel import mesh
from lidal_tpu_torch.runtime import evaluate, prob_inference, train_loop
from lidal_tpu_torch.runtime.paths import Paths, ensure_dir
from lidal_tpu_torch.runtime.train import TrainState, make_optimizer, sum_gradients, train_step
from lidal_tpu_torch.utils import profiling
from tests.test_torch_frames import OVERFLOW_CAPS, surface_frames

CAPS = (2048, 1024, 512, 256, 128)
P = 2048
NARROW = (8, 8, 16, 16, 32, 32, 16, 16, 16)  # tests/test_torch_minkunet.py's
LR = 1e-3
WORLD = 2
MODELS = ("Mink", "SPVCNN")
ROUND_FRAMES, N_SV, SEQ = 28, 4, "00"  # > 26 ring slots: the windows slide, chunks start mid-sequence
ROUND_CAP, ROUND_CAPS = 512, (512, 512, 256, 128, 64)
BN_ROWS = ((600, 590), (600, 3))  # (rows, valid rows) of rank 0 and rank 1
# the train step against JAX: (frames' seed, P, points, caps) of test_torch_train.py / test_torch_spvcnn.py
STEP_FRAMES = {"Mink": (61, 1024, 900, OVERFLOW_CAPS), "SPVCNN": (84, 512, 480, (512, 512, 256, 128, 32))}


def _points(b, seed):
    """numpy (xyz [b, P, 3], sig, valid, labels): rings of 0.9 P points."""
    rng = np.random.default_rng(seed)
    n = int(P * 0.9)
    xyz = np.zeros((b, P, 3), np.float32)
    sig = np.zeros((b, P), np.float32)
    valid = np.zeros((b, P), bool)
    labels = np.full((b, P), 255, np.int32)
    for i in range(b):
        r = rng.uniform(2, 40, n)
        th = rng.uniform(0, 2 * np.pi, n)
        xyz[i, :n] = np.stack([r * np.cos(th), r * np.sin(th), 0.1 * rng.standard_normal(n)], 1)
        sig[i, :n] = rng.random(n)
        valid[i, :n] = True
        labels[i, :n] = rng.integers(0, 19, n)
    return xyz, sig, valid, labels


def _loader(n_frames, batch_size, seed):
    xyz, sig, valid, labels = _points(n_frames, seed)

    def read(i):
        n = int(valid[i].sum())
        return xyz[i, :n], sig[i, :n], labels[i, :n]

    return FrameBatchLoader(list(range(n_frames)), read, point_cap=P, batch_size=batch_size, num_workers=1)


def _cfg(root, model_name="Mink", **kw):
    data = dataclasses.replace(SK_CONFIG, point_cap=P, level_caps=CAPS, batch_size=2, train_split=(SEQ,),
                               train_point_num=ROUND_FRAMES * P * 40)
    return RunConfig(model_name=model_name, metric_name="full", r_id=1, seed=3,
                     processing_root=os.path.join(root, "proc"), checkpoint_root=os.path.join(root, "ckpt"),
                     data_override=data, **kw)


def _narrow(model_name, group=None):
    """A narrow model without dropout (JAX's streams cannot be replayed), BNs summed over ``group``."""
    model = MinkUNet(19, cs=NARROW) if model_name == "Mink" else SPVCNN(19, cs=NARROW, dropout_rate=0.0)
    return sync_batchnorm(model, group)


def _narrow_run_train(*args, **kwargs):
    """run_train with the narrow widths (build_model's classes swapped)."""
    real = train_loop.MinkUNet, train_loop.SPVCNN
    train_loop.MinkUNet = functools.partial(MinkUNet, cs=NARROW)
    train_loop.SPVCNN = functools.partial(SPVCNN, cs=NARROW)
    try:
        return train_loop.run_train(*args, **kwargs)
    finally:
        train_loop.MinkUNet, train_loop.SPVCNN = real


def _step_frames(name):
    seed, p, n, _ = STEP_FRAMES[name]
    return surface_frames(seed, b=2, p=p, n=n)


def _train_batch(name, rows):
    xyz, sig, valid, labels = (torch.from_numpy(a[rows]) for a in _step_frames(name))
    return prepare_train_batch(None, xyz, sig, valid, labels, level_caps=STEP_FRAMES[name][3], augment=False,
                               with_points=name == "SPVCNN")


def _steps(state, tb, group=None, n=2):
    return [float(train_step(state, tb, None, group)) for _ in range(n)]


def _bn_inputs():
    rng = np.random.default_rng(9)
    out = []
    for rows, n_valid in BN_ROWS:
        x = (1.5 + 2.0 * rng.standard_normal((rows, 12))).astype(np.float32)
        valid = np.zeros(rows, bool)
        valid[rng.permutation(rows)[:n_valid]] = True
        out.append((x, valid, rng.standard_normal((rows, 12)).astype(np.float32)))
    return out


def _bn_run(x, valid, dy, group=None):
    bn = sync_batchnorm(MaskedBatchNorm(12), group).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 12))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 12))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt, torch.from_numpy(valid))
    (y * torch.from_numpy(dy)).sum().backward()
    return {"y": y.detach(), "dx": xt.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def _round_frames(n_frames=ROUND_FRAMES):
    """{name: (raw xyz, sig, registered xyz)}: frames of one static world (the
    first k the same for any ``n_frames`` >= k)."""
    rng = np.random.default_rng(11)
    world = (rng.random((600, 3)) * np.array([30, 30, 3]) - np.array([15, 15, 1])).astype(np.float32)
    out = {}
    for i in range(n_frames):
        seen = np.sort(rng.choice(len(world), 250, replace=False))  # one 256-query tile of nn_band
        reg = world[seen] + rng.normal(scale=0.01, size=(len(seen), 3)).astype(np.float32)
        out[f"{i:06d}"] = (reg - np.array([0.5 * i, 0, 0], np.float32), rng.random(len(seen)).astype(np.float32), reg)
    return out


def _round_cfg(root):
    cfg = _cfg(root)
    data = dataclasses.replace(cfg.data, point_cap=ROUND_CAP, level_caps=ROUND_CAPS)
    return dataclasses.replace(cfg, metric_name="LiDAL", label_unit="sv", r_id=2, inf_reps=2, view_chunk=2,
                               data_override=data)


def _write_round_tree(root, n_frames=ROUND_FRAMES):
    """An r_id = 2 scoring tree of ``n_frames``: round-1 flags (frame 0
    labelled), grids and supervoxel tables; no prob maps."""
    cfg = _round_cfg(root)
    paths, p1 = Paths(cfg), Paths(dataclasses.replace(cfg, r_id=1))
    grid_dir, svi_dir = ensure_dir(paths.grid_dir(SEQ)), ensure_dir(paths.supervoxel_dir(SEQ, "KMeans"))
    svf_dir = ensure_dir(p1.sv_flag_dir(SEQ))
    for i, (name, (_, _, reg)) in enumerate(sorted(_round_frames(n_frames).items())):
        np.savez_compressed(os.path.join(grid_dir, f"{name}.npz"), xyz=reg)
        point2sv = (np.arange(len(reg), dtype=np.int32) * N_SV) // len(reg)
        save_sv_info(os.path.join(svi_dir, f"{name}.npz"), point2sv, np.arange(i * N_SV, (i + 1) * N_SV))
        np.save(os.path.join(svf_dir, f"{name}.npy"), np.full(N_SV, int(i == 0), np.int32))
    return cfg


def _round_model():
    torch.manual_seed(5)
    return MinkUNet(19, cs=NARROW).eval()


def _round_io():
    """(names, read_fn for run_prob_inference, frame_id_fn, read_raw for the fused round)."""
    frames = _round_frames()
    names = sorted(frames)
    return (names, lambda name: frames[name][:2] + (None,), lambda name: (SEQ, name),
            lambda seq, name: frames[name][:2])


def _scored(run, *args, **kwargs):
    """(``run(...)`` as a tuple, the arrays its selection saw: flags, the two
    per-supervoxel scores, point counts and centres)."""
    seen = []
    select = lidal_runner.lidal.select

    def recording(*a, **k):
        seen.append([np.array(x) for x in a[:5]])
        return select(*a, **k)

    lidal_runner.lidal.select = recording
    try:
        res = run(*args, **kwargs)
    finally:
        lidal_runner.lidal.select = select
    return tuple(res), seen[0]


def _flags(cfg):
    d = Paths(cfg).sv_flag_dir(SEQ)
    return {n: np.load(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def _maps(cfg):
    prev = Paths(lidal_runner._prev_cfg(cfg))
    return {(kind, n): np.load(os.path.join(d, n)) for kind, d in (("prob", prev.prob_dir(SEQ)),
                                                                    ("pred", prev.pred_dir(SEQ)))
            for n in sorted(os.listdir(d))}


class _Partial(torch.nn.Module):
    """A parameter that gets a gradient and one that never does."""

    def __init__(self):
        super().__init__()
        self.used = torch.nn.Parameter(torch.arange(6, dtype=torch.float32))
        self.unused = torch.nn.Parameter(torch.ones(3))


def _host_command(rank, root, port):
    """``prep`` under torchrun's environment with a 1 s group timeout: rank 0
    runs the stage (it sleeps 3 s) without a group, rank 1 returns at once;
    (rank, exit code, seconds, whether a group existed during the stage)."""
    ran = []

    def slow_prep(cfg, stage):
        ran.append(dist.is_initialized())
        time.sleep(3.0)

    env = {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(WORLD), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    real_prep, real_timeout = commands.prep_command, mesh.GROUP_TIMEOUT
    commands.prep_command, mesh.GROUP_TIMEOUT = slow_prep, datetime.timedelta(seconds=1)
    t0 = time.monotonic()
    try:
        code = cli.main(["prep", "--stage", "grids", "--processing_root", os.path.join(root, "prep"), "--device",
                         "cpu"])
    finally:
        commands.prep_command, mesh.GROUP_TIMEOUT = real_prep, real_timeout
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return code, time.monotonic() - t0, ran


def _rank_main(rank, init_file, root, port):
    """One rank of the gloo group: every sharded case, results under ``root``."""
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=WORLD)
    group = dist.group.WORLD
    out = {}
    try:
        # (a) run_train: a loader of global batches of 4, two per rank
        for name in MODELS:
            losses = []
            st = _narrow_run_train(_cfg(os.path.join(root, f"train_{name}"), name), _loader(8, 4, 1), max_iter=2,
                                   on_step=lambda s, loss: losses.append(float(loss)), device="cpu", group=group)
            out[f"run_train_{name}"] = (losses, st.model.state_dict())
        # (b) sync-BN: this rank's rows of very unequal valid counts
        out["bn"] = _bn_run(*_bn_inputs()[rank], group=group)
        # the gradient sum leaves a parameter without a gradient without one
        part = _Partial()
        (part.used * (rank + 1)).sum().backward()
        sum_gradients(part, group)
        out["sum_gradients"] = (part.used.grad.clone(), part.unused.grad)
        # (c) eval: 10 frames in global batches of 4 (the last padded with 2 invalid frames)
        res = evaluate.run_eval(_cfg(root), _round_model(), _loader(10, 4, 3), "cpu",
                                torch.Generator().manual_seed(4), group=group)
        out["eval"] = (res.confusion, res.overflow, res.points, res.miou)
        # (f, g) inference over this rank's share of the list, then the staged round; the fused round
        names, read, fid, read_raw = _round_io()
        cfg = _round_cfg(os.path.join(root, "staged"))
        share = mesh.process_shard(len(names), group)
        prob_inference.run_prob_inference(lidal_runner._prev_cfg(cfg), _round_model(),
                                          names[share.start : share.stop], read, fid, device="cpu",
                                          first_index=share.start)
        mesh.sync_hosts("prob_inference", group)
        out["staged"] = _scored(lidal_runner.run_lidal_round, cfg, device="cpu", group=group)
        cfg = _round_cfg(os.path.join(root, "fused"))
        out["fused"] = _scored(lidal_runner.run_fused_lidal_round, cfg, _round_model(), read_raw, device="cpu",
                               group=group)
        # (a) the sharded train step from the JAX-initialised weights (written meanwhile by the
        # parent process), 2 steps on this rank's frame
        for name in MODELS:
            path = os.path.join(root, f"w0_{name}.pt")
            deadline = time.monotonic() + 600
            while not os.path.exists(path):
                assert time.monotonic() < deadline, f"no {path}"
                time.sleep(0.2)
            model = _narrow(name, group)
            model.load_state_dict(torch.load(path))
            state = TrainState(0, model, make_optimizer(model))
            out[f"step_{name}"] = (_steps(state, _train_batch(name, slice(rank, rank + 1)), group), model.state_dict())
        out["all_reduces"] = profiling.counter("all_reduce.calls")
    finally:
        dist.destroy_process_group()
    out["host_command"] = _host_command(rank, root, port)
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


def _jax_init(name):
    """A narrow JAX model (no dropout) initialised on the global batch: its
    state and its two train steps on the same batch."""
    import jax
    import jax.numpy as jnp

    from lidal_tpu.data.pipeline import prepare_train_batch as jax_prepare_train_batch
    from lidal_tpu.models import MinkUNet as JaxMinkUNet
    from lidal_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
    from lidal_tpu.runtime import train as jtrain

    spv = name == "SPVCNN"
    xyz, sig, valid, labels = (jnp.asarray(a) for a in _step_frames(name))
    tb = jax_prepare_train_batch(jax.random.split(jax.random.PRNGKey(0), 2), xyz, sig, valid, labels,
                                 level_caps=STEP_FRAMES[name][3], augment=False, with_points=spv)
    model = JaxSPVCNN(num_classes=19, cs=NARROW, dropout_rate=0.0) if spv else JaxMinkUNet(num_classes=19, cs=NARROW)
    tx = jtrain.make_optimizer()
    states = [jtrain.init_state(model, jax.random.PRNGKey(1), tb, tx)]
    step = jax.jit(jtrain.make_train_step(model, tx, with_points=spv))
    losses = []
    for _ in range(2):
        st, loss = step(states[-1], tb, jax.random.PRNGKey(2))
        states.append(jax.device_get(st))
        losses.append(float(loss))
    return states, losses


def _state_dict_from_jax(name, jstate):
    from lidal_tpu_torch.runtime.weights import minkunet_state_dict_from_jax, spvcnn_state_dict_from_jax

    conv = spvcnn_state_dict_from_jax if name == "SPVCNN" else minkunet_state_dict_from_jax
    return conv({"params": jstate.params, "batch_stats": jstate.batch_stats})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's narrow models and steps, then the two ranks' results."""
    root = str(tmp_path_factory.mktemp("parallel"))
    base = os.path.join(root, "round_base")
    _write_round_tree(base)
    for tree in ("staged", "fused"):
        shutil.copytree(base, os.path.join(root, tree))
    with socket.socket() as sock:  # a free port of 127.0.0.1 for the host-command case
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = tmp_mp.start_processes(_rank_main, args=(os.path.join(root, "init"), root, port), nprocs=WORLD,
                                   join=False, start_method="spawn")
    try:
        jax_runs = {}
        for name in MODELS:
            states, losses = _jax_init(name)
            jax_runs[name] = ([_state_dict_from_jax(name, s) for s in states], losses)
            path = os.path.join(root, f"w0_{name}.pt")
            torch.save(jax_runs[name][0][0], path + ".tmp")
            os.replace(path + ".tmp", path)  # the ranks wait for it
    finally:
        while not procs.join():
            pass
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return root, jax_runs, ranks


def _assert_params_close(got, want, what, stats_tol=(2e-4, 2e-6)):
    far = total = 0
    for name, w in want.items():
        if "running" in name:
            rtol, atol = stats_tol
            if name.startswith("point_transforms.") and name.endswith("running_mean"):
                # its input carries a Linear bias whose gradient is 0 by construction (the BN
                # removes it): Adam moves that bias by up to lr either way on rounding noise,
                # and the running mean takes momentum (0.1) of the difference a step
                atol += 0.1 * 2 * LR
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol, atol, err_msg=f"{what}: {name}")
            continue
        d = (got[name] - w).abs()
        assert float(d.max()) <= 2 * LR, f"{what}: {name} off by {float(d.max())}"
        far += int((d > 1e-2 * LR).sum())
        total += d.numel()
    assert far <= 1e-3 * total, f"{what}: {far} of {total} entries differ by more than 1e-2 * lr"


@pytest.mark.parametrize("name", MODELS)
def test_sharded_train_step_equals_single_process_and_jax(runs, name):
    """2 steps over 2 ranks == 2 steps of one process == 2 JAX steps, from
    the same JAX-initialised weights on the same (unaugmented) batch."""
    _, jax_runs, ranks = runs
    want_states, want_losses = jax_runs[name]
    model = _narrow(name)
    model.load_state_dict(want_states[0])
    state = TrainState(0, model, make_optimizer(model))
    tb = _train_batch(name, slice(0, 2))
    losses = []
    for i in range(2):
        losses += _steps(state, tb, n=1)
        _assert_params_close(model.state_dict(), want_states[i + 1], f"single vs JAX, step {i + 1}", (1e-5, 1e-5))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    single = model.state_dict()
    for r, res in enumerate(ranks):
        got_losses, got = res[f"step_{name}"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5, err_msg=f"rank {r}")
        _assert_params_close(got, single, f"rank {r} vs single")
    for k, v in ranks[0][f"step_{name}"][1].items():  # the ranks apply the same summed step
        assert torch.equal(v, ranks[1][f"step_{name}"][1][k]), k


@pytest.mark.parametrize("name", MODELS)
def test_sharded_run_train_equals_single_process(runs, name, tmp_path):
    """run_train over 2 ranks (each its rows of the loader's global batches,
    their rows of the batch's augmentation and SPVCNN's dropout seeds) ==
    run_train in one process; rank 0 wrote the checkpoint."""
    root, _, ranks = runs
    losses = []
    st = _narrow_run_train(_cfg(str(tmp_path), name), _loader(8, 4, 1), max_iter=2,
                           on_step=lambda s, loss: losses.append(float(loss)), device="cpu")
    for r, res in enumerate(ranks):
        got_losses, got = res[f"run_train_{name}"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5, err_msg=f"rank {r}")
        _assert_params_close(got, st.model.state_dict(), f"rank {r}")
    saved = torch.load(os.path.join(Paths(_cfg(os.path.join(root, f"train_{name}"), name)).ckpt_dir(),
                                    "current_port.pt"), weights_only=True)
    assert saved["iteration"] == 2
    for k, v in ranks[0][f"run_train_{name}"][1].items():
        assert torch.equal(saved["model_state"][k], v), k


def test_run_train_needs_a_batch_the_ranks_split(monkeypatch, tmp_path):
    """A caller's loader of batches of 3 over 2 ranks is refused: the group
    never shrinks to fewer ranks than it has."""
    monkeypatch.setattr(mesh, "world", lambda group: 2)
    with pytest.raises(ValueError, match="does not split"):
        _narrow_run_train(_cfg(str(tmp_path)), _loader(6, 3, 2), max_iter=2, device="cpu", group=object())


def test_gradient_sum_keeps_a_missing_gradient_missing(runs):
    """Over 2 ranks the gradients are summed, and a parameter without one
    stays without one (Adam skips it, as on one device)."""
    _, _, ranks = runs
    for r in ranks:
        used, unused = r["sum_gradients"]
        np.testing.assert_array_equal(used.numpy(), np.full(6, 3.0, np.float32))
        assert unused is None


def test_sync_batchnorm_over_unequal_valid_counts(runs):
    """Output, running statistics and gradients of the BN over both ranks'
    rows (590 and 3 valid) equal one BN over the concatenated rows; the mean
    of the two ranks' means is far from the mean of all rows."""
    _, _, ranks = runs
    inputs = _bn_inputs()
    one = _bn_run(*(np.concatenate(parts) for parts in zip(*inputs)))

    def close(got, want, what):
        tol = 1e-6 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol, what

    close(torch.cat([r["bn"]["y"] for r in ranks]), one["y"], "y")
    close(torch.cat([r["bn"]["dx"] for r in ranks]), one["dx"], "dx")
    for k in ("dweight", "dbias"):  # parameter gradients: summed over the ranks by train_step
        close(ranks[0]["bn"][k] + ranks[1]["bn"][k], one[k], k)
    for k in ("running_mean", "running_var"):
        for r in ranks:
            close(r["bn"][k], one[k], k)
    x_all = np.concatenate([x[v] for x, v, _ in inputs])
    mean_of_means = np.mean([x[v].mean(0) for x, v, _ in inputs], axis=0)
    assert np.abs(mean_of_means - x_all.mean(0)).max() > 0.1


def test_sharded_eval_confusion_and_overflow_equal_single_process(runs):
    _, _, ranks = runs
    res = evaluate.run_eval(_cfg("unused"), _round_model(), _loader(10, 4, 3), "cpu", torch.Generator().manual_seed(4))
    assert res.overflow.sum() > 0 and res.points == int(_points(10, 3)[2].sum())
    for r in ranks:
        conf, overflow, points, miou = r["eval"]
        np.testing.assert_array_equal(conf, res.confusion)
        np.testing.assert_array_equal(overflow, res.overflow)
        assert points == res.points and miou == res.miou


def test_sharded_eval_needs_a_batch_the_ranks_split(monkeypatch):
    monkeypatch.setattr(mesh, "world", lambda group: 2)
    with pytest.raises(ValueError, match="does not split"):
        evaluate.run_eval(_cfg("unused"), _narrow("Mink"), _loader(3, 3, 0), "cpu", group=object())


def test_padded_final_batch_splits_into_the_same_frames():
    """Rows 0:2 and 2:4 of a loader of 5 frames in batches of 4 are the
    global batches' rows, the padded final batch's too, and each share has
    a static 2 rows."""
    whole = list(_loader(5, 4, 0))
    shares = [list(_loader(5, 4, 0).with_rows(lo, lo + 2)) for lo in (0, 2)]
    assert [b["n_frames"] for b in whole] == [4, 1]
    assert [[b["n_frames"] for b in s] for s in shares] == [[2, 1], [2, 0]]
    for lo, share in zip((0, 2), shares):
        for b, w in zip(share, whole):
            assert b["files"] == w["files"][lo : lo + 2]
            for k in ("xyz", "sig", "valid", "labels"):
                np.testing.assert_array_equal(b[k], w[k][lo : lo + 2])
    with pytest.raises(ValueError):
        _loader(5, 4, 0).with_rows(3, 5)


def _single_round(tmp_path, tag, fused):
    cfg = _write_round_tree(str(tmp_path / tag))
    names, read, fid, read_raw = _round_io()
    if fused:
        return cfg, _scored(lidal_runner.run_fused_lidal_round, cfg, _round_model(), read_raw, device="cpu")
    prob_inference.run_prob_inference(lidal_runner._prev_cfg(cfg), _round_model(), names, read, fid, device="cpu")
    return cfg, _scored(lidal_runner.run_lidal_round, cfg, device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_lidal_round_over_ranks_equals_one_process(runs, tmp_path, fused):
    """The staged round (inference over each rank's share of the frames,
    then scoring) and the fused round see bit-equal supervoxel scores,
    select the same supervoxels, write the same flags and prob / pred maps
    over two ranks as in one process (rank 1's ring starts mid-sequence)."""
    root, _, ranks = runs
    cfg1, (one, seen) = _single_round(tmp_path, "one", fused)
    assert len(one[1]) > 0 and (one[0] == 2).any()  # supervoxels for labels and for pseudo labels
    tag = "fused" if fused else "staged"
    for r in ranks:
        other, other_seen = r[tag]
        for a, b in zip(seen, other_seen):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(one, other):
            np.testing.assert_array_equal(a, b)
    cfg_g = _round_cfg(os.path.join(root, tag))
    for k, v in _flags(cfg1).items():
        np.testing.assert_array_equal(_flags(cfg_g)[k], v, err_msg=str(k))
    maps = _maps(cfg_g)
    assert set(maps) == set(_maps(cfg1))
    for k, v in _maps(cfg1).items():
        np.testing.assert_array_equal(maps[k], v, err_msg=str(k))


def test_prob_inference_equal_across_shares(monkeypatch):
    """One call over the list and one call per rank's share of it
    (process_shard over 2 and 3 ranks) give bit-equal maps: each frame's
    views are seeded by its index in the whole list."""
    names, read, fid, _ = _round_io()
    cfg = lidal_runner._prev_cfg(_round_cfg("unused"))
    model = _round_model()
    one = prob_inference.run_prob_inference(cfg, model, names, read, fid, save=False, device="cpu")
    assert len(one) == len(names)
    for world in (2, 3):
        monkeypatch.setattr(mesh, "world", lambda group, world=world: world)
        shares = {}
        for r in range(world):
            monkeypatch.setattr(mesh, "rank", lambda group, r=r: r)
            share = mesh.process_shard(len(names), object())
            shares.update(prob_inference.run_prob_inference(cfg, model, names[share.start : share.stop], read, fid,
                                                            save=False, device="cpu", first_index=share.start))
        assert set(shares) == set(one)
        for k, (prob, pred, feat) in one.items():
            np.testing.assert_array_equal(shares[k][0], prob)
            np.testing.assert_array_equal(shares[k][1], pred)
            assert feat is None and shares[k][2] is None


def test_a_failed_frame_fails_the_run(tmp_path):
    """A frame that cannot be read, on the reader or the ring's prefetch
    thread, fails inference and the fused round."""
    names, read, fid, read_raw = _round_io()

    def bad_read(name):
        if name == names[5]:
            raise OSError("unreadable frame (injected)")
        return read(name)

    cfg = lidal_runner._prev_cfg(_round_cfg("unused"))
    with pytest.raises(OSError, match="injected"):
        prob_inference.run_prob_inference(cfg, _round_model(), names[:6], bad_read, fid, save=False, device="cpu")
    cfg = _write_round_tree(str(tmp_path), n_frames=6)
    with pytest.raises(OSError, match="injected"):
        lidal_runner.run_fused_lidal_round(cfg, _round_model(), lambda s, n: bad_read(n)[:2], device="cpu")


def test_all_reduces_ran_in_the_ranks(runs):
    _, _, ranks = runs
    assert all(r["all_reduces"] > 0 for r in ranks)


def test_host_commands_wait_on_no_collective(runs):
    """Under torchrun's environment ``prep`` joins no group: rank 0 runs the
    stage alone for 3 s, past a 1 s group timeout, rank 1 returns at once,
    and both exit 0."""
    _, _, ranks = runs
    (code0, t0, ran0), (code1, t1, ran1) = (r["host_command"] for r in ranks)
    assert (code0, code1) == (0, 0)
    assert ran0 == [False] and ran1 == []
    assert t0 >= 3.0 and t1 < t0 - 2.0  # rank 1 did not wait for rank 0's stage


def test_init_from_env_joins_with_the_round_timeout(monkeypatch):
    """torchrun's environment: a gloo group on the CPU, an NCCL one for
    ``cuda``, both with GROUP_TIMEOUT, not torch's 10-minute default."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    for k, v in {"RANK": "1", "LOCAL_RANK": "1", "WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(k, v)
    assert mesh.init_from_env("cpu") == torch.device("cpu")
    assert mesh.init_from_env("cuda") == torch.device("cuda", 1)
    assert [b for b, _ in calls] == ["gloo", "nccl"]
    for _, kw in calls:
        assert kw["timeout"] == mesh.GROUP_TIMEOUT >= datetime.timedelta(hours=1)
        assert (kw["rank"], kw["world_size"], kw["init_method"]) == (1, 2, "env://")
    assert calls[1][1]["device_id"] == torch.device("cuda", 1)


def test_init_group_joins_at_the_given_address(monkeypatch):
    """A launcher's own ranks: gloo on the CPU, NCCL on ``cuda:rank`` (or the
    card named), at the address and with the timeout given."""
    calls, current = [], []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    short = datetime.timedelta(minutes=10)
    assert mesh.init_group(2, 4, "tcp://127.0.0.1:29500", "cpu", short) == torch.device("cpu")
    assert mesh.init_group(3, 4, "tcp://127.0.0.1:29500", "cuda") == torch.device("cuda", 3)
    assert mesh.init_group(0, 4, "file:///x", "cuda:1") == torch.device("cuda", 1)
    assert [b for b, _ in calls] == ["gloo", "nccl", "nccl"] and current == [torch.device("cuda", 3),
                                                                              torch.device("cuda", 1)]
    assert [(kw["rank"], kw["world_size"], kw["init_method"]) for _, kw in calls] == [
        (2, 4, "tcp://127.0.0.1:29500"), (3, 4, "tcp://127.0.0.1:29500"), (0, 4, "file:///x")]
    assert [kw["timeout"] for _, kw in calls] == [short, mesh.GROUP_TIMEOUT, mesh.GROUP_TIMEOUT]
    assert [kw["device_id"] for _, kw in calls] == [None, torch.device("cuda", 3), torch.device("cuda", 1)]


def test_mesh_without_a_group(monkeypatch):
    """Without a process group: rank 0 of 1, the whole range, no barrier, a
    sum over one rank; init_from_env creates no group when WORLD_SIZE is
    unset or 1."""
    assert not dist.is_initialized()
    assert (mesh.rank(None), mesh.world(None)) == (0, 1)
    assert mesh.process_shard(7, None) == range(0, 7)
    mesh.sync_hosts("fence", None)
    t = torch.arange(3.0)
    assert mesh.all_reduce_(t, None) is t
    for env in ({}, {"WORLD_SIZE": "1"}):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert mesh.init_from_env("cpu") == torch.device("cpu")
        assert not dist.is_initialized()


@pytest.mark.parametrize("n,world,want", [(7, 2, [(0, 4), (4, 7)]), (3, 4, [(0, 1), (1, 2), (2, 3), (3, 3)]),
                                          (8, 4, [(0, 2), (2, 4), (4, 6), (6, 8)])])
def test_process_shard_splits_contiguously(monkeypatch, n, world, want):
    monkeypatch.setattr(mesh, "world", lambda group: world)
    got = []
    for r in range(world):
        monkeypatch.setattr(mesh, "rank", lambda group, r=r: r)
        share = mesh.process_shard(n, object())
        got.append((share.start, share.stop))
    assert got == want
