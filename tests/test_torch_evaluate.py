"""Port parity of the whole eval slice (``lidal_tpu_torch/runtime/evaluate.py``):
raw points -> prepare_eval_batch -> MinkUNet -> projection -> confusion ->
mIoU, JAX package vs port on the same frames and weights; plus ``run_eval``
over a list of loader-style batch dicts.  The same for SPVCNN
(``model_name="SPVCNN"``: the batch carries the point plan).  The overflow
warnings drain at the JAX package's points of the loop (``_OVF_DRAIN``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.config import DataConfig, RunConfig
from lidal_tpu.data.pipeline import prepare_eval_batch as jax_prepare_eval_batch
from lidal_tpu.models import MinkUNet as JaxMinkUNet
from lidal_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from lidal_tpu.runtime import evaluate as jax_evaluate
from lidal_tpu.utils import iou as jax_iou
from lidal_tpu_torch.data.pipeline import prepare_eval_batch
from lidal_tpu_torch.data.pipeline import forward_batch
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.runtime.evaluate import batch_confusion, project_logits_to_points, run_eval
from lidal_tpu_torch.runtime.weights import minkunet_state_dict_from_jax, spvcnn_state_dict_from_jax
from lidal_tpu_torch.utils import iou
from tests.test_torch_frames import OVERFLOW_CAPS, surface_frames, torch_args
from tests.test_torch_minkunet import NARROW, _randomise_bn


def test_confusion_and_iou_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 19, 5000).astype(np.int32)
    gt = rng.integers(0, 19, 5000).astype(np.int32)
    gt[rng.random(5000) < 0.2] = 255
    got = iou.confusion_matrix(*torch_args(pred, gt), 19).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_iou.confusion_matrix(jnp.asarray(pred), jnp.asarray(gt), 19)))
    np.testing.assert_array_equal(got, jax_iou.confusion_matrix_np(pred, gt, 19))
    for g, w in zip(iou.per_class_iou(got), jax_iou.per_class_iou(got)):
        np.testing.assert_array_equal(g, w)
    assert iou.evaluate(got) == jax_iou.evaluate(got)


def test_projection_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 40, 5)).astype(np.float32)
    inverse = rng.integers(0, 41, (2, 60)).astype(np.int32)
    got = project_logits_to_points(*torch_args(logits, inverse)).numpy()
    for b in range(2):
        want = jax_evaluate.project_logits_to_points(jnp.asarray(logits[b]), jnp.asarray(inverse[b]))
        np.testing.assert_array_equal(got[b], np.asarray(want))


@pytest.fixture(scope="module")
def narrow_models():
    """A narrow JAX MinkUNet with random BN statistics and the port carrying its weights."""
    xyz, sig, valid, _ = surface_frames(41, b=2)
    eb = jax_prepare_eval_batch(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(xyz), jnp.asarray(sig),
        jnp.asarray(valid), level_caps=OVERFLOW_CAPS, augment=False,
    )
    jmodel = JaxMinkUNet(num_classes=19, cs=NARROW)
    variables = jax.jit(jmodel.init, static_argnames="train")(jax.random.PRNGKey(3), eb.feats, eb.plan, train=False)
    variables = _randomise_bn(variables, np.random.default_rng(4))
    model = MinkUNet(num_classes=19, cs=NARROW)
    model.load_state_dict(minkunet_state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model.eval()


def test_eval_slice_confusion_equals_jax(narrow_models):
    jmodel, variables, model = narrow_models
    xyz, sig, valid, labels = surface_frames(42, b=2, n=950)

    eb_j = jax_prepare_eval_batch(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(xyz), jnp.asarray(sig),
        jnp.asarray(valid), level_caps=OVERFLOW_CAPS, augment=False,
    )
    logits_j, _ = jax.jit(jmodel.apply, static_argnames="train")(variables, eb_j.feats, eb_j.plan, train=False)
    conf_j = np.asarray(jax_evaluate.batch_confusion(logits_j, eb_j.inverse, eb_j.point_valid, jnp.asarray(labels), 19))

    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=OVERFLOW_CAPS, augment=False)
    with torch.inference_mode():
        logits, _ = model(eb.feats, eb.plan)
    conf = batch_confusion(logits, eb.inverse, eb.point_valid, torch.from_numpy(labels), 19).numpy()

    # equal class decisions need every valid voxel's top-2 margin above the
    # 1e-4 logit tolerance of test_torch_minkunet.py
    top2 = np.sort(np.asarray(logits_j), axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0])[np.asarray(eb_j.plan.levels[0].valid)]
    assert margin.min() > 1e-3, margin.min()
    assert conf.sum() == int(np.asarray(eb_j.point_valid).sum()) > 0
    np.testing.assert_array_equal(conf, conf_j)
    np.testing.assert_array_equal(eb.overflow.numpy(), np.asarray(eb_j.overflow))
    assert iou.per_class_iou(conf)[0].tolist() == pytest.approx(jax_iou.per_class_iou(conf_j)[0].tolist(), nan_ok=True)


def test_run_eval_over_batch_dicts(narrow_models, capsys):
    _, _, model = narrow_models
    data = DataConfig(name="SK", num_classes=19, point_cap=1024, level_caps=OVERFLOW_CAPS)
    cfg = RunConfig(data_override=data)
    batches = []
    for seed in (43, 44):
        xyz, sig, valid, labels = surface_frames(seed, b=2)
        batches.append({"xyz": xyz, "sig": sig, "valid": valid, "labels": labels, "trunc_points": seed - 43})

    res = run_eval(cfg, model, batches, torch.device("cpu"), torch.Generator().manual_seed(5), verbose=True)

    gen = torch.Generator().manual_seed(5)
    conf = torch.zeros((19, 19), dtype=torch.int64)
    overflow = np.zeros(len(OVERFLOW_CAPS), np.int64)
    with torch.inference_mode():
        for b in batches:
            eb = prepare_eval_batch(gen, *torch_args(b["xyz"], b["sig"], b["valid"]), level_caps=OVERFLOW_CAPS)
            logits, _ = model(eb.feats, eb.plan)
            conf += batch_confusion(logits, eb.inverse, eb.point_valid, torch.from_numpy(b["labels"]), 19)
            overflow += eb.overflow.sum(dim=0).numpy()
    np.testing.assert_array_equal(res.confusion, conf.numpy())
    np.testing.assert_array_equal(res.overflow, overflow)
    assert res.points == sum(int(b["valid"].sum()) for b in batches)
    iou_c, _, _ = iou.per_class_iou(conf.numpy())
    assert res.miou == float(np.nan_to_num(iou_c, nan=0.0).mean())
    out = capsys.readouterr().out
    assert res.overflow.sum() > 0 and "WARNING: capacity overflow" in out
    assert f"mean IOU {res.miou}" in out  # the reference-format table


def test_spvcnn_eval_slice_confusion_equals_jax_and_run_eval_takes_the_point_plan():
    xyz, sig, valid, labels = surface_frames(45, b=2, n=950)
    eb_j = jax_prepare_eval_batch(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(xyz), jnp.asarray(sig),
        jnp.asarray(valid), level_caps=OVERFLOW_CAPS, with_points=True, augment=False,
    )
    jmodel = JaxSPVCNN(num_classes=19, cs=NARROW)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(3), eb_j.feats, eb_j.plan, eb_j.pplan, train=False
    )
    variables = _randomise_bn(variables, np.random.default_rng(4))
    logits_j, _ = jax.jit(jmodel.apply, static_argnames="train")(
        variables, eb_j.feats, eb_j.plan, eb_j.pplan, train=False
    )
    conf_j = np.asarray(jax_evaluate.batch_confusion(logits_j, eb_j.inverse, eb_j.point_valid, jnp.asarray(labels), 19))

    model = SPVCNN(num_classes=19, cs=NARROW)
    model.load_state_dict(spvcnn_state_dict_from_jax(variables), strict=True)
    model.eval()
    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=OVERFLOW_CAPS, augment=False, with_points=True)
    with torch.inference_mode():
        logits, _ = forward_batch(model, eb)
    conf = batch_confusion(logits, eb.inverse, eb.point_valid, torch.from_numpy(labels), 19).numpy()
    # equal class decisions need every valid voxel's top-2 margin above twice
    # the logits' distance, itself within the 1e-4 of test_torch_spvcnn.py
    dist = np.abs(logits.numpy() - np.asarray(logits_j)).max()
    top2 = np.sort(np.asarray(logits_j), axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0])[np.asarray(eb_j.plan.levels[0].valid)]
    assert dist <= 1e-4 and margin.min() > 2 * dist, (dist, margin.min())
    assert conf.sum() == int(np.asarray(eb_j.point_valid).sum()) > 0
    np.testing.assert_array_equal(conf, conf_j)

    # run_eval: cfg.is_spvcnn prepares the batch with its point plan
    data = DataConfig(name="SK", num_classes=19, point_cap=1024, level_caps=OVERFLOW_CAPS)
    cfg = RunConfig(model_name="SPVCNN", data_override=data)
    assert cfg.is_spvcnn
    batch = {"xyz": xyz, "sig": sig, "valid": valid, "labels": labels}
    res = run_eval(cfg, model, [batch], "cpu", torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    with torch.inference_mode():
        eb = prepare_eval_batch(gen, *torch_args(xyz, sig, valid), level_caps=OVERFLOW_CAPS, with_points=True)
        want = batch_confusion(forward_batch(model, eb)[0], eb.inverse, eb.point_valid, torch.from_numpy(labels), 19)
    np.testing.assert_array_equal(res.confusion, want.numpy())
    assert res.points == int(valid.sum())


def test_overflow_warnings_drain_where_jax_drains_them(narrow_models, monkeypatch):
    """With the drain window at 2 in both packages, over 5 batches that
    overflow a level cap, each warning is printed after the same number of
    batches has left the loader: batches 0-1 after 2, 2-3 after 4, 4 after
    the loop, as the window's own docstring in each package says."""
    from lidal_tpu.runtime.train import make_eval_step
    from lidal_tpu_torch.runtime import evaluate

    jmodel, variables, model = narrow_models
    data = DataConfig(name="SK", num_classes=19, point_cap=1024, level_caps=OVERFLOW_CAPS)
    batches = []
    for seed in range(50, 55):
        xyz, sig, valid, labels = surface_frames(seed, b=2)
        batches.append({"xyz": xyz, "sig": sig, "valid": valid, "labels": labels, "trunc_points": 0})

    def counting(module):
        """(loader over the batches, [(batches yielded, warning)]): ``module.print`` records."""
        seen = {"n": 0}
        printed = []

        def loader():
            for b in batches:
                seen["n"] += 1
                yield b

        monkeypatch.setattr(module, "_OVF_DRAIN", 2)
        monkeypatch.setattr(module, "print", lambda *a, **k: printed.append((seen["n"], " ".join(map(str, a)))),
                            raising=False)
        return loader(), printed

    loader, jax_printed = counting(jax_evaluate)
    jax_evaluate.run_eval(RunConfig(data_override=data), make_eval_step(jmodel, with_points=False), variables,
                          loader, verbose=False, n_devices=1)
    loader, port_printed = counting(evaluate)
    res = run_eval(RunConfig(data_override=data), model, loader, torch.device("cpu"))

    def points(printed):
        return [(n, msg.rsplit(" ", 1)[1]) for n, msg in printed if msg.startswith("WARNING: capacity overflow")]

    want = [(2, "0"), (2, "1"), (4, "2"), (4, "3"), (5, "4")]
    assert points(jax_printed) == want
    assert points(port_printed) == want
    assert res.overflow.sum() > 0
