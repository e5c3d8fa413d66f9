"""The port's training loop (``lidal_tpu_torch/runtime/train_loop.py``,
``runtime/checkpoint.py``, ``data/loader.py``, ``data/selection.py``) on the
synthetic mini-SemanticKITTI of ``tests/synth.py`` at ``TEST_CAPS``:

* the training file lists and labels of the r0, full, fr, sv and sv-pseudo
  modes equal ``lidal_tpu``'s, and the round-0 bootstrap writes the same flags;
* the loaders yield equal batches, and a failing reader raises in the consumer;
* ``run_train`` writes its checkpoint, a second call resumes the step count,
  and round 1 warm-starts from ``0r`` with a fresh optimizer; the same loop
  with ``model_name="SPVCNN"`` trains, checkpoints and resumes an SPVCNN;
* (slow) train -> checkpoint -> ``run_eval`` learns a separable 2-class set.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lidal_tpu.data import loader as jloader
from lidal_tpu.data import selection as jselection
from lidal_tpu.runtime import train_loop as jtrain_loop
from lidal_tpu.runtime.paths import Paths
from lidal_tpu_torch.data import semantic_kitti as sk
from lidal_tpu_torch.data import selection
from lidal_tpu_torch.data.loader import FrameBatchLoader
from lidal_tpu_torch.runtime import checkpoint as ckpt
from lidal_tpu_torch.runtime import train_loop
from tests.synth import make_mini_sk, mini_cfg


def _seq_frames(cfg):
    return {s: sk.list_frames(cfg.data_root, [s]) for s in cfg.data.train_split}


def _write_sv_tree(cfg, rng):
    """Supervoxel tables for every frame, round-1 sv flags (0 / 1 human / 2
    pseudo) for the LiDAL namespace, and round-0 pseudo-label dumps."""
    paths = Paths(cfg)
    prev = Paths(dataclasses.replace(cfg, r_id=0, label_unit="fr"))
    for seq, frames in _seq_frames(cfg).items():
        for d in (paths.supervoxel_dir(seq), paths.sv_flag_dir(seq), prev.pred_dir(seq)):
            os.makedirs(d, exist_ok=True)
        for i, fr in enumerate(frames):
            name = selection.frame_name(fr)
            n_pts = len(sk.read_frame(fr, with_labels=False)[0])
            n_sv = 5
            selection.save_sv_info(
                os.path.join(paths.supervoxel_dir(seq), f"{name}.npz"),
                rng.integers(-1, n_sv, n_pts), np.arange(n_sv) + 100 * i,
            )
            flags = rng.integers(0, 3, n_sv) if i % 3 else np.zeros(n_sv, np.int64)  # every 3rd frame unlabeled
            np.save(os.path.join(paths.sv_flag_dir(seq), f"{name}.npy"), flags)
            np.save(os.path.join(prev.pred_dir(seq), f"{name}.npy"), rng.integers(0, 19, n_pts).astype(np.int32))


@pytest.fixture(scope="module")
def list_root(tmp_path_factory):
    """150 tiny frames per sequence, so the 1 % bootstrap draws real frames."""
    d = str(tmp_path_factory.mktemp("lists"))
    make_mini_sk(d, seqs=("00", "01"), frames_per_seq=150, points=60, seed=3)
    cfg = mini_cfg(d, r_id=1, metric_name="LiDAL", label_unit="sv")
    _write_sv_tree(cfg, np.random.default_rng(4))
    ff = Paths(dataclasses.replace(cfg, label_unit="fr")).frame_flag_dir()
    os.makedirs(ff, exist_ok=True)
    rng = np.random.default_rng(5)
    for seq, frames in _seq_frames(cfg).items():
        np.save(os.path.join(ff, f"{seq}.npy"), rng.random(len(frames)) < 0.2)
    return d


@pytest.mark.parametrize(
    "r_id,label_unit,metric",
    [(0, "fr", "LiDAL"), (1, "sv", "full"), (1, "fr", "LiDAL"), (1, "sv", "LiDAL"), (1, "sv", "LiDAL_pseudo")],
)
def test_train_lists_and_labels_match_jax(list_root, r_id, label_unit, metric):
    cfg = mini_cfg(list_root, r_id=r_id, label_unit=label_unit, metric_name=metric)
    want = jtrain_loop.build_train_loader(cfg, shuffle=False)  # writes the round-0 tree first when r_id == 0
    got = train_loop.build_train_loader(cfg, shuffle=False)
    assert got.files == want.files and len(got.files) > 0
    assert (got.point_cap, got.batch_size, got.seed) == (want.point_cap, want.batch_size, want.seed)
    for f in got.files[:4]:
        for a, b in zip(got.read_fn(f), want.read_fn(f)):
            np.testing.assert_array_equal(a, b)
    if label_unit == "sv" and metric != "full":
        labels = np.concatenate([got.read_fn(f)[2] for f in got.files])
        assert (labels == 255).any() and (labels != 255).any()


def test_bootstrap_round0_writes_jax_flags(tmp_path):
    make_mini_sk(str(tmp_path), seqs=("00",), frames_per_seq=120, points=60, seed=6)
    trees = {}
    for name, lib in (("jax", jselection), ("port", selection)):
        cfg = mini_cfg(str(tmp_path), seqs=("00",), r_id=0)
        cfg = dataclasses.replace(cfg, processing_root=str(tmp_path / name))
        lib.bootstrap_round0(cfg, _seq_frames(cfg))
        trees[name] = np.load(os.path.join(Paths(cfg).frame_flag_dir(r_id=0), "00.npy"))
    np.testing.assert_array_equal(trees["port"], trees["jax"])
    assert trees["port"].sum() > 0


def test_loader_batches_match_jax(list_root):
    cfg = mini_cfg(list_root, r_id=1, metric_name="full")
    files = _seq_frames(cfg)["00"][:7]
    read = train_loop.make_sk_read_fn(cfg)
    kw = dict(point_cap=48, batch_size=3, shuffle=True, seed=11, num_workers=2)  # 60 points: truncates
    got, want = FrameBatchLoader(files, read, **kw), jloader.FrameBatchLoader(files, read, **kw)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        bg, bw = list(got), list(want)
        assert len(bg) == len(bw) == 3
        for a, b in zip(bg, bw):
            assert a.keys() == b.keys() and a["files"] == b["files"] and a["trunc_points"] == b["trunc_points"]
            for k in ("xyz", "sig", "valid", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
    assert bg[-1]["n_frames"] == 1 and bg[0]["trunc_points"] > 0


def test_loader_reader_failure_raises_in_consumer():
    def bad_read(f):
        if f == "b":
            raise OSError("unreadable frame")
        return np.zeros((4, 3), np.float32), np.zeros(4, np.float32), np.zeros(4, np.int32)

    loader = FrameBatchLoader(["a", "b", "c"], bad_read, point_cap=8, batch_size=1)
    with pytest.raises(OSError, match="unreadable"):
        list(loader)


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mini_sk"))
    make_mini_sk(d, seqs=("00", "01"), frames_per_seq=6, points=700)
    return d


def _label_first_frames(cfg, n):
    selection.bootstrap_round0(cfg, _seq_frames(cfg))
    ff_dir = Paths(cfg).frame_flag_dir(r_id=0)
    for s in cfg.data.train_split:
        flag = np.zeros(len(_seq_frames(cfg)[s]), bool)
        flag[:n] = True
        np.save(os.path.join(ff_dir, f"{s}.npy"), flag)


def test_run_train_checkpoints_resumes_and_warm_starts(mini_root, capsys):
    cfg = mini_cfg(mini_root, r_id=0, label_unit="fr", max_iter=2, ckpt_every=2)
    _label_first_frames(cfg, 2)
    steps = []
    state = train_loop.run_train(cfg, log_every=1, on_step=lambda s, loss: steps.append((s, float(loss))),
                                 device="cpu")
    assert state.step == 2 and [s for s, _ in steps] == [1, 2]
    assert all(np.isfinite(loss) and loss > 0 for _, loss in steps)
    path = ckpt.ckpt_path(Paths(cfg).ckpt_dir())
    assert path.endswith(os.path.join("0r", "current_port.pt")) and os.path.exists(path)
    out = capsys.readouterr().out
    assert "Train_0r samples: 4" in out and "Iteration: 2 loss:" in out
    saved = torch.load(path, weights_only=True)
    assert saved["iteration"] == 2 and set(saved) == {"model_state", "optimizer", "iteration", "ep_id"}
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["model_state"][k], v), k

    # same round: resume the step count, optimizer and weights, then go on
    steps.clear()
    state = train_loop.run_train(cfg, max_iter=3, on_step=lambda s, loss: steps.append(s), device="cpu")
    assert state.step == 3 and steps == [3]
    assert torch.load(path, weights_only=True)["iteration"] == 3
    assert float(state.optimizer.state_dict()["state"][0]["step"]) == 3.0

    # round 1 ('full' metric): warm start from 0r's weights, fresh optimizer and step
    cfg1 = dataclasses.replace(cfg, r_id=1, metric_name="full")
    warm, ep = ckpt.resume_or_warm_start(Paths(cfg1), train_loop.init_state(cfg1, torch.device("cpu")))
    assert warm.step == 0 and ep == 0 and not warm.optimizer.state_dict()["state"]
    for k, v in warm.model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k
    state1 = train_loop.run_train(cfg1, max_iter=1, device="cpu")
    assert state1.step == 1 and os.path.exists(ckpt.ckpt_path(Paths(cfg1).ckpt_dir()))
    assert Paths(cfg1).ckpt_dir().endswith(os.path.join("Mink", "full"))


def test_spvcnn_run_train_checkpoints_and_resumes(mini_root):
    """``model_name="SPVCNN"``: ``run_train`` builds the SPVCNN, prepares its
    batches with the point plan, draws per-frame dropout seeds, and the
    checkpoint round-trips the point branch."""
    from lidal_tpu_torch.models.spvcnn import SPVCNN

    cfg = mini_cfg(mini_root, r_id=0, label_unit="fr", max_iter=2, ckpt_every=2, model_name="SPVCNN")
    _label_first_frames(cfg, 2)
    steps = []
    state = train_loop.run_train(cfg, on_step=lambda s, loss: steps.append((s, float(loss))), device="cpu")
    assert isinstance(state.model, SPVCNN) and state.model.dropout.rate == 0.3
    assert state.step == 2 and all(np.isfinite(loss) and loss > 0 for _, loss in steps)
    path = ckpt.ckpt_path(Paths(cfg).ckpt_dir())
    assert Paths(cfg).ckpt_dir().endswith(os.path.join("SPVCNN", "0r")) and os.path.exists(path)
    saved = torch.load(path, weights_only=True)
    assert saved["iteration"] == 2
    assert {f"point_transforms.{i}.1.running_var" for i in range(3)} <= set(saved["model_state"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["model_state"][k], v), k

    # a fresh state restores to the trained one, Adam moments of the point branch included
    fresh = train_loop.init_state(dataclasses.replace(cfg, seed=cfg.seed + 1), torch.device("cpu"))
    assert not torch.equal(fresh.model.point_transforms[0][0].weight, state.model.point_transforms[0][0].weight)
    assert ckpt.restore_checkpoint(Paths(cfg).ckpt_dir(), fresh) is not None and fresh.step == 2
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k
    n_params = len(list(fresh.model.parameters()))
    assert len(fresh.optimizer.state_dict()["state"]) == n_params

    # the same round resumes and goes on
    steps.clear()
    state = train_loop.run_train(cfg, max_iter=3, on_step=lambda s, loss: steps.append(s), device="cpu")
    assert state.step == 3 and steps == [3]
    # a MinkUNet run of the same round has its own checkpoint directory
    assert Paths(dataclasses.replace(cfg, model_name="Mink")).ckpt_dir() != Paths(cfg).ckpt_dir()


@pytest.mark.slow
def test_port_learns_separable_classes(tmp_path):
    """Learnability of the port's train -> checkpoint -> eval path (the JAX
    package's ``tests/test_learning.py``): a break in the loss, labels,
    backward, BN or projection leaves the present-class mIoU near chance."""
    from lidal_tpu_torch.models.minkunet import MinkUNet
    from lidal_tpu_torch.runtime.evaluate import run_eval
    from lidal_tpu_torch.utils.iou import per_class_iou

    make_mini_sk(str(tmp_path), seqs=("00",), frames_per_seq=5, points=700, separable=True)
    cfg = mini_cfg(str(tmp_path), seqs=("00",), label_unit="fr", r_id=0, max_iter=200, ckpt_every=200)
    _label_first_frames(cfg, 5)
    train_loop.run_train(cfg, log_every=100, device="cpu")

    model = MinkUNet(num_classes=cfg.data.num_classes)
    model.load_state_dict(torch.load(ckpt.ckpt_path(Paths(cfg).ckpt_dir()), weights_only=True)["model_state"])
    files = sk.list_frames(cfg.data_root, cfg.data.val_split)
    loader = FrameBatchLoader(files, lambda p: sk.read_frame(p, with_labels=True), point_cap=cfg.data.point_cap,
                              batch_size=1)
    res = run_eval(cfg, model, loader, torch.device("cpu"), torch.Generator().manual_seed(1))
    iou, _, _ = per_class_iou(res.confusion)
    present = res.confusion.sum(0) > 0
    assert present.sum() == 2
    miou_present = float(np.nan_to_num(iou, nan=0.0)[present].mean())
    print(f"port MinkUNet: present-class mIoU after 200 steps = {miou_present:.3f}")
    assert miou_present > 0.8, (miou_present, iou[present])
