"""Port parity of ``lidal_tpu_torch/runtime/prob_inference.py``: multi-view
prob / pred / outfeat against a JAX composition of the same stages on the same
frames and weights, and the port's own invariances with augmentation on.

Tolerances.  Against JAX, ``augment=False`` (JAX PRNG streams cannot be
replayed in torch; every view is then the same frame, so the view mean is one
view's softmax): prob and outfeat within 1e-4 (a narrow network's ~20 layers
of f32 sums in another order, as ``tests/test_torch_minkunet.py``), pred equal
wherever the top-2 probabilities are more than 1e-3 apart.  View-chunk
invariance within 1e-6 (the view sum is taken in another order, and a conv
row's f32 sum may depend on the batch it runs in); order and repeat
invariance bit-equal (one generator per frame from its global index).  One
SPVCNN case (``model_name="SPVCNN"``) holds prob, pred and outfeat to the same
tolerances.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.data.pipeline import prepare_eval_batch as jax_prepare_eval_batch
from lidal_tpu.models import MinkUNet as JaxMinkUNet
from lidal_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from lidal_tpu.runtime import evaluate as jax_evaluate
from lidal_tpu.runtime import prob_inference as jax_prob
from lidal_tpu_torch.config import DataConfig, RunConfig
from lidal_tpu_torch.data.augment import sample_augment
from lidal_tpu_torch.data.pipeline import forward_batch, prepare_eval_batch
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.runtime import prob_inference
from lidal_tpu_torch.runtime.evaluate import project_logits_to_points
from lidal_tpu_torch.runtime.paths import Paths
from lidal_tpu_torch.utils import profiling
from lidal_tpu_torch.runtime.weights import minkunet_state_dict_from_jax, spvcnn_state_dict_from_jax
from tests.test_torch_frames import OVERFLOW_CAPS, surface_frames
from tests.test_torch_minkunet import NARROW, _randomise_bn

P = 1024


def _cfg(tmp, **kw):
    data = DataConfig(name="SK", num_classes=19, point_cap=P, level_caps=OVERFLOW_CAPS)
    base = dict(metric_name="LiDAL", label_unit="sv", r_id=1, inf_reps=2, view_chunk=1, seed=11,
                processing_root=os.path.join(str(tmp), "proc"), data_override=data)
    base.update(kw)
    return RunConfig(**base)


@pytest.fixture(scope="module")
def models():
    """A narrow JAX MinkUNet with random BN statistics and the port carrying its weights."""
    xyz, sig, valid, _ = surface_frames(61, b=1)
    eb = jax_prepare_eval_batch(
        jax.random.split(jax.random.PRNGKey(0), 1), jnp.asarray(xyz), jnp.asarray(sig), jnp.asarray(valid),
        level_caps=OVERFLOW_CAPS, augment=False,
    )
    jmodel = JaxMinkUNet(num_classes=19, cs=NARROW)
    variables = jax.jit(jmodel.init, static_argnames="train")(jax.random.PRNGKey(3), eb.feats, eb.plan, train=False)
    variables = _randomise_bn(variables, np.random.default_rng(4))
    model = MinkUNet(num_classes=19, cs=NARROW)
    model.load_state_dict(minkunet_state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model.eval()


def _frames(seed, count):
    """[(xyz [n, 3], sig [n])] with different point counts, as a reader returns them."""
    xyz, sig, valid, _ = surface_frames(seed, b=count, n=900)
    return [(xyz[i, : 900 - 37 * i], sig[i, : 900 - 37 * i]) for i in range(count)]


@pytest.mark.parametrize("r_id", [0, 1])
def test_multiview_outputs_match_jax_composition(models, tmp_path, r_id):
    jmodel, variables, model = models
    frames = _frames(62, 2)
    cfg = _cfg(tmp_path, r_id=r_id, label_unit="fr" if r_id == 0 else "sv")
    assert prob_inference.wants_outfeat(cfg) == jax_prob.wants_outfeat(cfg) == (r_id == 0)
    got = prob_inference.run_prob_inference(
        cfg, model, [0, 1], read_fn=lambda i: frames[i] + (None,), frame_id_fn=lambda i: ("00", f"{i:06d}"),
        save=False, device="cpu", augment=False,
    )
    apply = jax.jit(jmodel.apply, static_argnames="train")
    for i, (xyz, sig) in enumerate(frames):
        n = len(xyz)
        pad = np.zeros((1, P, 3), np.float32)
        pad[0, :n] = xyz
        psig = np.zeros((1, P), np.float32)
        psig[0, :n] = sig
        eb = jax_prepare_eval_batch(
            jax.random.split(jax.random.PRNGKey(0), 1), jnp.asarray(pad), jnp.asarray(psig),
            jnp.asarray(np.arange(P)[None] < n), level_caps=OVERFLOW_CAPS, augment=False,
        )
        logits, feat = apply(variables, eb.feats, eb.plan, train=False)
        want = np.asarray(jax.nn.softmax(jax_evaluate.project_logits_to_points(logits[0], eb.inverse[0]), axis=-1))[:n]
        want_feat = np.asarray(jax_evaluate.project_logits_to_points(feat[0], eb.inverse[0]))[:n]

        prob, pred, outfeat = got[("00", f"{i:06d}")]
        assert prob.shape == (n, 19) and prob.dtype == np.float32 and pred.shape == (n,) and pred.dtype == np.int32
        np.testing.assert_allclose(prob, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(prob.sum(1), 1.0, atol=1e-5)
        top2 = np.sort(want, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(pred[clear], want.argmax(1)[clear])
        if r_id == 0:
            assert outfeat.shape == (n, NARROW[8]) and outfeat.dtype == np.float32
            np.testing.assert_allclose(outfeat, want_feat, rtol=0, atol=1e-4)
        else:
            assert outfeat is None


def test_view_chunk_and_feature_branch_invariance(models, tmp_path):
    """With augmentation on: the view mean does not depend on ``view_chunk``
    (all views' parameters are drawn at once), a non-divisor chunk falls back
    to a divisor, and dropping the feature branch changes nothing else."""
    _, _, model = models
    (xyz, sig), = _frames(63, 1)
    args = [torch.from_numpy(a) for a in prob_inference.pad_points(xyz, sig, None, P)[:3]]
    outs = {}
    with torch.inference_mode():
        for vc in (4, 2, 3, 1):  # monolithic; divisor; non-divisor (-> 2); one view at a time
            cfg = _cfg(tmp_path, inf_reps=4, view_chunk=vc)
            fn = prob_inference.make_multiview_fn(cfg, model, with_feat=True)
            outs[vc] = [t.numpy() for t in fn(prob_inference.frame_generator(cfg.seed, 7), *args)]
        nf = prob_inference.make_multiview_fn(_cfg(tmp_path, inf_reps=4, view_chunk=2), model, with_feat=False)
        prob_nf, pred_nf, feat_nf = nf(prob_inference.frame_generator(11, 7), *args)
        one_view = prob_inference.make_multiview_fn(_cfg(tmp_path, inf_reps=1), model)(
            prob_inference.frame_generator(11, 7), *args)[0].numpy()
    for vc in (2, 3, 1):
        np.testing.assert_allclose(outs[vc][0], outs[4][0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(outs[vc][2], outs[4][2], rtol=0, atol=1e-5)
        assert (outs[vc][1] == outs[4][1]).mean() > 0.999
    np.testing.assert_array_equal(outs[3][0], outs[2][0])  # 3 does not divide 4: chunks of 2
    assert feat_nf is None
    np.testing.assert_array_equal(prob_nf.numpy(), outs[2][0])
    np.testing.assert_array_equal(pred_nf.numpy(), outs[2][1])
    # the views do differ: the mean of 4 views is not the first view alone
    assert np.abs(outs[4][0] - one_view).max() > 1e-3


def test_cpu_chunks_are_eager_plans_and_capture_nothing(models, tmp_path):
    """On the CPU no plan graph is made: every chunk is ``prepare_eval_batch``
    on the chunk's rows of the frame's draws, and the outputs equal that
    composition bit for bit."""
    _, _, model = models
    (xyz, sig), = _frames(65, 1)
    args = [torch.from_numpy(a) for a in prob_inference.pad_points(xyz, sig, None, P)[:3]]
    cfg = _cfg(tmp_path, inf_reps=4, view_chunk=2)
    profiling.reset()
    with torch.inference_mode():
        prob, pred, feat = prob_inference.make_multiview_fn(cfg, model, with_feat=True)(
            prob_inference.frame_generator(cfg.seed, 3), *args)
        draws = sample_augment(prob_inference.frame_generator(cfg.seed, 3), 4)
        want_prob = want_feat = 0.0
        for c0 in (0, 2):
            eb = prepare_eval_batch(None, *(a.expand((2,) + a.shape) for a in args), level_caps=OVERFLOW_CAPS,
                                    draws=draws.rows(c0, c0 + 2))
            logits, f = forward_batch(model, eb)
            want_prob = want_prob + torch.softmax(project_logits_to_points(logits, eb.inverse).float(), -1).sum(0)
            want_feat = want_feat + project_logits_to_points(f, eb.inverse).float().sum(0)
    assert torch.equal(prob, want_prob / 4) and torch.equal(feat, want_feat / 4)
    assert torch.equal(pred, prob.argmax(-1).to(torch.int32))
    assert profiling.counter("plan_graph.capture") == profiling.counter("plan_graph.replay") == 0
    assert prob_inference._PLAN_GRAPHS == {}


def test_frames_do_not_depend_on_order_or_repeats(models, tmp_path):
    """A frame's output depends on its global index only: running the frames in
    another order, alone, or twice gives the same bits; another index or seed
    gives other views."""
    _, _, model = models
    frames = _frames(64, 3)
    cfg = _cfg(tmp_path, inf_reps=2, view_chunk=2)
    kw = dict(read_fn=lambda i: frames[i] + (None,), frame_id_fn=lambda i: ("00", f"{i:06d}"), save=False, device="cpu")
    first = prob_inference.run_prob_inference(cfg, model, [0, 1, 2], **kw)
    again = prob_inference.run_prob_inference(cfg, model, [0, 1, 2], **kw)
    fn = prob_inference.make_multiview_fn(cfg, model)
    with torch.inference_mode():
        for i in (2, 0, 1):  # another order, each frame on its own
            args = [torch.from_numpy(a) for a in prob_inference.pad_points(*frames[i], None, P)[:3]]
            prob, pred, _ = fn(prob_inference.frame_generator(cfg.seed, i), *args)
            n = len(frames[i][0])
            for res in (first, again):
                np.testing.assert_array_equal(res[("00", f"{i:06d}")][0], prob.numpy()[:n])
                np.testing.assert_array_equal(res[("00", f"{i:06d}")][1], pred.numpy()[:n])
        other_index = fn(prob_inference.frame_generator(cfg.seed, 5), *args)[0]
        other_seed = fn(prob_inference.frame_generator(cfg.seed + 1, 1), *args)[0]
    assert float((other_index - prob).abs().max()) > 1e-4 and float((other_seed - prob).abs().max()) > 1e-4


def test_saved_artifacts_and_writer_failure(models, tmp_path, monkeypatch):
    """``save=True`` writes prob / pred (and outfeat at round 0) where
    ``runtime/paths.py`` says; a failed write fails the run."""
    _, _, model = models
    frames = _frames(65, 3)
    kw = dict(read_fn=lambda i: frames[i] + (None,), frame_id_fn=lambda i: ("03", f"{i:06d}"), device="cpu")
    cfg = _cfg(tmp_path, r_id=0, label_unit="fr")
    assert prob_inference.run_prob_inference(cfg, model, [0, 1, 2], **kw) is None
    want = prob_inference.run_prob_inference(cfg, model, [0, 1, 2], save=False, **kw)
    paths = Paths(cfg)
    for i in range(3):
        n = len(frames[i][0])
        prob = np.load(os.path.join(paths.prob_dir("03"), f"{i:06d}.npy"))
        pred = np.load(os.path.join(paths.pred_dir("03"), f"{i:06d}.npy"))
        feat = np.load(os.path.join(paths.outfeat_dir("03"), f"{i:06d}.npy"))
        assert prob.shape == (n, 19) and pred.shape == (n,) and feat.shape == (n, NARROW[8])
        for got, ref in zip((prob, pred, feat), want[("03", f"{i:06d}")]):
            np.testing.assert_array_equal(got, ref)
            assert got.dtype == ref.dtype

    real_save = np.save

    def failing_save(path, arr, *a, **k):
        if os.sep + "pred" + os.sep in str(path) and str(path).endswith("000001.npy"):
            raise OSError("disk full (injected)")
        return real_save(path, arr, *a, **k)

    monkeypatch.setattr(np, "save", failing_save)
    cfg1 = dataclasses.replace(_cfg(tmp_path / "failing"), r_id=1)
    with pytest.raises(OSError, match="injected"):
        prob_inference.run_prob_inference(cfg1, model, [0, 1, 2], **kw)


def test_spvcnn_multiview_outputs_match_jax_composition(tmp_path):
    """``model_name="SPVCNN"``: every view is prepared with its point plan."""
    xyz0, sig0, valid0, _ = surface_frames(61, b=1)
    eb0 = jax_prepare_eval_batch(
        jax.random.split(jax.random.PRNGKey(0), 1), jnp.asarray(xyz0), jnp.asarray(sig0), jnp.asarray(valid0),
        level_caps=OVERFLOW_CAPS, with_points=True, augment=False,
    )
    jmodel = JaxSPVCNN(num_classes=19, cs=NARROW)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(3), eb0.feats, eb0.plan, eb0.pplan, train=False
    )
    variables = _randomise_bn(variables, np.random.default_rng(4))
    model = SPVCNN(num_classes=19, cs=NARROW)
    model.load_state_dict(spvcnn_state_dict_from_jax(variables), strict=True)

    frames = _frames(66, 2)
    cfg = _cfg(tmp_path, r_id=0, label_unit="fr", model_name="SPVCNN")
    got = prob_inference.run_prob_inference(
        cfg, model, [0, 1], read_fn=lambda i: frames[i] + (None,), frame_id_fn=lambda i: ("00", f"{i:06d}"),
        save=False, device="cpu", augment=False,
    )
    apply = jax.jit(jmodel.apply, static_argnames="train")
    for i, (xyz, sig) in enumerate(frames):
        n = len(xyz)
        pad = np.zeros((1, P, 3), np.float32)
        pad[0, :n] = xyz
        psig = np.zeros((1, P), np.float32)
        psig[0, :n] = sig
        eb = jax_prepare_eval_batch(
            jax.random.split(jax.random.PRNGKey(0), 1), jnp.asarray(pad), jnp.asarray(psig),
            jnp.asarray(np.arange(P)[None] < n), level_caps=OVERFLOW_CAPS, with_points=True, augment=False,
        )
        logits, feat = apply(variables, eb.feats, eb.plan, eb.pplan, train=False)
        want = np.asarray(jax.nn.softmax(jax_evaluate.project_logits_to_points(logits[0], eb.inverse[0]), axis=-1))[:n]
        want_feat = np.asarray(jax_evaluate.project_logits_to_points(feat[0], eb.inverse[0]))[:n]
        prob, pred, outfeat = got[("00", f"{i:06d}")]
        np.testing.assert_allclose(prob, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(outfeat, want_feat, rtol=0, atol=1e-4)
        top2 = np.sort(want, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(pred[clear], want.argmax(1)[clear])
    # a model without the point branch cannot take these batches
    with pytest.raises(TypeError):
        prob_inference.run_prob_inference(
            cfg, MinkUNet(num_classes=19, cs=NARROW), [0], read_fn=lambda i: frames[i] + (None,),
            frame_id_fn=lambda i: ("00", f"{i:06d}"), save=False, device="cpu", augment=False,
        )
