"""Port parity: the eval MinkUNet (``lidal_tpu_torch/models``) with weights
carried over by ``runtime/weights.minkunet_state_dict_from_jax``.

* narrow widths, flax-initialised JAX variables (BN statistics randomised so
  the fused epilogues do real work): logits and penultimate features within
  rtol = atol = 1e-4 of the JAX f32 forward (sums of up to 27 * 384 products
  in another order, through ~20 layers), argmax equal;
* full width: a random torchsparse-layout state dict goes through
  ``convert_minkunet_state_dict`` and the same map into the port, and is held
  against the numpy oracle of the reference network driven by the state dict
  directly (``tests/ts_oracle.py``), at the 2e-3 of ``test_oracle_parity.py``.
  Both together are the weight round trip: torchsparse names -> flax tree ->
  port names, checked by value through two independent forwards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.data.pipeline import prepare_eval_batch as jax_prepare_eval_batch
from lidal_tpu.models import MinkUNet as JaxMinkUNet
from lidal_tpu.runtime.import_torch import convert_minkunet_state_dict
from lidal_tpu_torch.data.pipeline import prepare_eval_batch
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.runtime.weights import minkunet_state_dict_from_jax
from tests import ts_oracle
from tests.test_torch_frames import OVERFLOW_CAPS, surface_frames, torch_args

NARROW = (8, 8, 16, 16, 32, 32, 16, 16, 16)


def _randomise_bn(tree, rng):
    """Random BN affine and running statistics (numpy copies of the flax tree)."""
    params = jax.tree_util.tree_map(np.array, tree["params"])
    stats = jax.tree_util.tree_map(np.array, tree["batch_stats"])

    def walk(p, s):
        for name, sub in p.items():
            if name.startswith("MaskedBatchNorm"):
                c = sub["scale"].shape[0]
                sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                sub["bias"] = rng.normal(scale=0.1, size=c).astype(np.float32)
                s[name]["mean"] = rng.normal(scale=0.1, size=c).astype(np.float32)
                s[name]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(sub, dict) and name in s:
                walk(sub, s[name])

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


def test_narrow_minkunet_matches_jax():
    xyz, sig, valid, _ = surface_frames(31, b=2, p=1024, n=900)
    caps = OVERFLOW_CAPS
    eb_j = jax_prepare_eval_batch(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(xyz), jnp.asarray(sig),
        jnp.asarray(valid), level_caps=caps, augment=False,
    )
    jmodel = JaxMinkUNet(num_classes=19, cs=NARROW)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(1), eb_j.feats, eb_j.plan, train=False
    )
    variables = _randomise_bn(variables, np.random.default_rng(2))
    logits_j, feat_j = jax.jit(jmodel.apply, static_argnames="train")(
        variables, eb_j.feats, eb_j.plan, train=False
    )

    model = MinkUNet(num_classes=19, cs=NARROW)
    model.load_state_dict(minkunet_state_dict_from_jax(variables), strict=True)
    model.eval()
    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=caps, augment=False)
    with torch.inference_mode():
        logits, feat = model(eb.feats, eb.plan)

    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=1e-4, atol=1e-4)
    valid0 = eb.plan.levels[0].valid.numpy()
    assert valid0.any() and not np.asarray(logits_j)[~valid0].any()
    np.testing.assert_array_equal(
        logits.numpy().argmax(-1)[valid0], np.asarray(logits_j).argmax(-1)[valid0]
    )


def test_training_mode_is_refused():
    """The fused eval-BN epilogue refuses train mode: batch statistics need the
    conv's whole output first (``test_training_mode_runs`` takes the train path)."""
    bn = MinkUNet(num_classes=19, cs=NARROW).stem[1]
    assert bn.training
    with pytest.raises(RuntimeError):
        bn.fused_affine()
    a, b = bn.eval().fused_affine()
    assert a.shape == b.shape == (NARROW[0],)


def test_training_mode_runs():
    """A fresh model is in train mode: the forward takes the train-mode layers
    (differentiable convs, batch statistics) and gives finite logits that
    are zero on invalid voxels and carry gradients to every weight."""
    torch.manual_seed(0)
    model = MinkUNet(num_classes=19, cs=NARROW)
    xyz, sig, valid, _ = surface_frames(32, b=1)
    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=OVERFLOW_CAPS, augment=False)
    logits, feat = model(eb.feats, eb.plan)
    valid0 = eb.plan.levels[0].valid
    assert logits.shape == (1, OVERFLOW_CAPS[0], 19) and feat.shape == (1, OVERFLOW_CAPS[0], NARROW[8])
    assert bool(torch.isfinite(logits).all()) and not logits[~valid0].any() and logits[valid0].abs().sum() > 0
    logits[valid0].square().mean().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.parameters())


def _oracle_frames():
    rng = np.random.default_rng(0)
    b, p = 2, 2048
    xyz = np.zeros((b, p, 3), np.float32)
    sig = np.zeros((b, p), np.float32)
    valid = np.zeros((b, p), bool)
    for bi in range(b):
        n = 1200 + 100 * bi
        r = rng.uniform(2, 40, n)
        th = rng.uniform(0, 2 * np.pi, n)
        xyz[bi, :n] = np.stack([r * np.cos(th), r * np.sin(th), 0.1 * rng.standard_normal(n)], 1)
        sig[bi, :n] = rng.random(n)
        valid[bi, :n] = True
    return xyz, sig, valid


def test_full_width_minkunet_matches_reference_oracle():
    caps = (2048,) * 5  # lossless: the oracle has no capacities
    xyz, sig, valid = _oracle_frames()
    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=caps, augment=False)
    assert int(eb.overflow.sum()) == 0

    sd = ts_oracle.random_minkunet_state_dict(np.random.default_rng(1))
    model = MinkUNet(num_classes=19)
    model.load_state_dict(minkunet_state_dict_from_jax(convert_minkunet_state_dict(sd)), strict=True)
    model.eval()
    with torch.inference_mode():
        logits, feat = model(eb.feats, eb.plan)

    coords = eb.plan.levels[0].coords.numpy()
    valid0 = eb.plan.levels[0].valid.numpy()
    feats = eb.feats.numpy()
    cs, fs, rows = [], [], []
    for bi in range(coords.shape[0]):
        idx = np.where(valid0[bi])[0]
        rows.extend((bi, int(i)) for i in idx)
        cs.append(np.concatenate([coords[bi, idx], np.full((len(idx), 1), bi, coords.dtype)], axis=1))
        fs.append(feats[bi, idx])
    logits_o, feat_o = ts_oracle.Oracle(sd).minkunet_forward(np.concatenate(cs), np.concatenate(fs))

    got_l = np.stack([logits[bi, ri].numpy() for bi, ri in rows])
    got_y = np.stack([feat[bi, ri].numpy() for bi, ri in rows])
    np.testing.assert_allclose(got_y, feat_o, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_l, logits_o, rtol=2e-3, atol=2e-3)
    assert (got_l.argmax(1) == logits_o.argmax(1)).mean() > 0.999
