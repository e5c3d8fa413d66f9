"""Port parity of train mode: ``MaskedBatchNorm`` with batch statistics,
``cross_entropy_ignore``, ``prepare_train_batch``, and whole narrow-MinkUNet
train steps (``lidal_tpu_torch/runtime/train.py``) against the JAX package,
from the same carried-over variables.

Tolerances:
* BN output and statistics: rtol = atol = 1e-5 (f32 sums over ~1600 voxels
  in another order);
* loss: rtol 1e-5; gradients: each parameter's within 1e-4 * max(1e-3, its
  largest JAX entry) elementwise: f32 sums in another order through ~40
  layers of backward, BN backward included, and an entry that cancels keeps
  the rounding of the large terms;
* parameters after Adam: Adam divides each gradient by its own running
  magnitude, so where a gradient is near zero its rounding noise becomes a
  step of up to lr in either direction.  Every parameter must lie within
  2 * lr of JAX's, and all but 1e-3 of the entries within 1e-2 * lr (1 % of
  a step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.data.pipeline import prepare_train_batch as jax_prepare_train_batch
from lidal_tpu.models import MinkUNet as JaxMinkUNet
from lidal_tpu.models.layers import MaskedBatchNorm as JaxMaskedBatchNorm
from lidal_tpu.runtime import train as jtrain
from lidal_tpu_torch.data.pipeline import prepare_train_batch
from lidal_tpu_torch.models.layers import MaskedBatchNorm
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.runtime.train import TrainState, cross_entropy_ignore, make_optimizer, train_step
from lidal_tpu_torch.runtime.weights import _to_torch, adam_state_from_jax, minkunet_state_dict_from_jax
from tests.test_torch_frames import OVERFLOW_CAPS, surface_frames, torch_args
from tests.test_torch_minkunet import NARROW

LR = 1e-3


@pytest.mark.parametrize("n_valid", [0, 1, 700])
def test_masked_batchnorm_train_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    x = (2.0 + 3.0 * rng.standard_normal((2, 800, 16))).astype(np.float32)
    valid = np.zeros((2, 800), bool)
    valid.reshape(-1)[rng.permutation(1600)[:n_valid]] = True
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    mean0 = rng.normal(size=16).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 16).astype(np.float32)

    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    y_j, upd = JaxMaskedBatchNorm().apply(
        variables, jnp.asarray(x), jnp.asarray(valid), True, mutable=["batch_stats"]
    )

    bn = MaskedBatchNorm(16).train()
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean0), ("running_var", var0)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    y = bn(*torch_args(x, valid)).detach().numpy()

    np.testing.assert_allclose(y, np.asarray(y_j), rtol=1e-5, atol=1e-5)
    assert not y[~valid].any()
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-5, atol=1e-5)
    if n_valid == 0:  # an empty batch: statistics decay towards (0, 0), output all zero
        np.testing.assert_allclose(bn.running_mean.numpy(), 0.9 * mean0, rtol=1e-6)
    bn.eval()  # and eval mode normalises with the updated running statistics
    y_e = bn(*torch_args(x, valid)).detach().numpy()
    want_e = (x - bn.running_mean.numpy()) / np.sqrt(bn.running_var.numpy() + 1e-5) * scale + bias
    np.testing.assert_allclose(y_e, want_e * valid[..., None], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ignored", [0.0, 0.3, 1.0])
def test_cross_entropy_ignore_matches_jax(ignored):
    rng = np.random.default_rng(int(ignored * 10))
    logits = (3 * rng.standard_normal((2, 300, 19))).astype(np.float32)
    labels = rng.integers(0, 19, (2, 300)).astype(np.int32)
    labels[rng.random((2, 300)) < ignored] = 255
    got = cross_entropy_ignore(*torch_args(logits, labels))
    want = jtrain.cross_entropy_ignore(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if ignored == 1.0:
        assert float(got) == 0.0  # F.cross_entropy would give NaN


@pytest.fixture(scope="module")
def frames():
    return surface_frames(61, b=2, p=1024, n=900)


def _jax_batch(frames):
    xyz, sig, valid, labels = frames
    return jax_prepare_train_batch(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(xyz), jnp.asarray(sig), jnp.asarray(valid),
        jnp.asarray(labels), level_caps=OVERFLOW_CAPS, augment=False,
    )


def test_prepare_train_batch_matches_jax(frames):
    tb_j = _jax_batch(frames)
    tb = prepare_train_batch(None, *torch_args(*frames), level_caps=OVERFLOW_CAPS, augment=False)
    np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(tb_j.labels))
    np.testing.assert_array_equal(tb.feats.numpy(), np.asarray(tb_j.feats))
    np.testing.assert_array_equal(tb.overflow.numpy(), np.asarray(tb_j.overflow))
    for lv, lv_j in zip(tb.plan.levels, tb_j.plan.levels):
        np.testing.assert_array_equal(lv.nbr3.numpy(), np.asarray(lv_j.nbr3))
    valid0 = tb.plan.levels[0].valid.numpy()
    assert (tb.labels.numpy()[~valid0] == 255).all() and (tb.labels.numpy()[valid0] < 19).all()
    assert tb.labels.dtype == torch.int32


@pytest.fixture(scope="module")
def jax_run(frames):
    """A narrow JAX MinkUNet: its initial state, the gradients of one step, and
    the states after 1, 2 and 3 Adam steps on the same batch."""
    tb_j = _jax_batch(frames)
    model = JaxMinkUNet(num_classes=19, cs=NARROW)
    tx = jtrain.make_optimizer()
    state0 = jtrain.init_state(model, jax.random.PRNGKey(1), tb_j, tx)

    def loss_fn(params):
        (logits, _), upd = model.apply(
            {"params": params, "batch_stats": state0.batch_stats}, tb_j.feats, tb_j.plan, train=True,
            mutable=["batch_stats"],
        )
        return jtrain.cross_entropy_ignore(logits, tb_j.labels), upd["batch_stats"]

    (loss, stats1), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state0.params)
    step = jax.jit(jtrain.make_train_step(model, tx, with_points=False))
    states, losses = [state0], []
    for _ in range(3):
        st, lo = step(states[-1], tb_j, jax.random.PRNGKey(2))
        states.append(st)
        losses.append(float(lo))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {
        "loss": float(loss), "grads": to_np(grads), "stats1": to_np(stats1), "losses": losses,
        "states": [jax.device_get(s) for s in states],
    }


def _port_state(jstate, with_adam: bool) -> TrainState:
    model = MinkUNet(num_classes=19, cs=NARROW)
    model.load_state_dict(
        minkunet_state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats}), strict=True
    )
    opt = make_optimizer(model)
    if with_adam:
        opt.load_state_dict(adam_state_from_jax(jstate.opt_state, model))
    return TrainState(step=int(jstate.step), model=model, optimizer=opt)


def _assert_params_close(model, jstate, what):
    want = minkunet_state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    far, total = 0, 0
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 2 * LR, f"{what}: {name} off by {d.max()}"
        far += int((d > 1e-2 * LR).sum())
        total += d.size
    assert far <= 1e-3 * total, f"{what}: {far} of {total} entries differ by more than 1e-2 * lr"


def test_train_step_loss_grads_and_stats_match_jax(frames, jax_run):
    state = _port_state(jax_run["states"][0], with_adam=False)
    tb = prepare_train_batch(None, *torch_args(*frames), level_caps=OVERFLOW_CAPS, augment=False)
    state.model.train()
    logits, _ = state.model(tb.feats, tb.plan)
    loss = cross_entropy_ignore(logits, tb.labels)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jax_run["loss"], rtol=1e-5)

    want_g = _to_torch(jax_run["grads"])
    named = dict(state.model.named_parameters())
    assert sorted(named) == sorted(want_g)
    for name, p in named.items():
        g, w = p.grad.numpy(), want_g[name].numpy()
        tol = 1e-4 * max(1e-3, np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
    assert any(np.abs(p.grad.numpy()).max() > 0 for n, p in named.items() if n.endswith("kernel"))

    stats = minkunet_state_dict_from_jax({"params": jax_run["states"][0].params, "batch_stats": jax_run["stats1"]})
    for name, buf in state.model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_three_adam_steps_match_jax(frames, jax_run):
    state = _port_state(jax_run["states"][0], with_adam=False)
    tb = prepare_train_batch(None, *torch_args(*frames), level_caps=OVERFLOW_CAPS, augment=False)
    for i in range(3):
        loss = train_step(state, tb)
        np.testing.assert_allclose(float(loss), jax_run["losses"][i], rtol=1e-5)
        _assert_params_close(state.model, jax_run["states"][i + 1], f"step {i + 1}")
    assert state.step == 3
    assert jax_run["losses"][2] < jax_run["losses"][0]


def test_adam_state_from_jax_continues_mid_training(frames, jax_run):
    """Start the port from the JAX state after 2 steps (Adam moments and
    count 2 carried over, so the bias correction is that of step 3)."""
    jstate2 = jax_run["states"][2]
    state = _port_state(jstate2, with_adam=True)
    assert state.step == 2
    st = state.optimizer.state_dict()["state"]
    assert float(st[0]["step"]) == 2.0 and any(float(s["exp_avg_sq"].abs().max()) > 0 for s in st.values())
    tb = prepare_train_batch(None, *torch_args(*frames), level_caps=OVERFLOW_CAPS, augment=False)
    loss = train_step(state, tb)
    np.testing.assert_allclose(float(loss), jax_run["losses"][2], rtol=1e-5)
    _assert_params_close(state.model, jax_run["states"][3], "resumed step 3")
    # a fresh Adam would take a full-size first step instead
    fresh = _port_state(jstate2, with_adam=False)
    train_step(fresh, tb)
    diffs = [
        float((p - q).detach().abs().max()) for p, q in zip(fresh.model.parameters(), state.model.parameters())
    ]
    assert max(diffs) > 0.1 * LR
