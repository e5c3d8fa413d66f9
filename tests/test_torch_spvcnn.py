"""Port parity of SPVCNN (``lidal_tpu_torch/models/spvcnn.py``) as a whole,
with weights carried over by ``runtime/weights.spvcnn_state_dict_from_jax``.

* narrow widths, flax-initialised variables with randomised BN: eval logits and
  ``z3`` within rtol = atol = 1e-4 of the JAX f32 forward (the trunk's sums of
  up to 27 * 48 products and the point branch's gathers in another order,
  through ~25 layers), zero on invalid rows, argmax equal;
* full width: a random torchsparse-layout state dict through
  ``convert_spvcnn_state_dict`` and the same map, against the numpy oracle of
  the reference network (``tests/ts_oracle.py``) at the 2e-3 of
  ``test_oracle_parity.py``;
* one train step with ``dropout_rate = 0`` (JAX random streams cannot be
  replayed in torch) against ``make_train_step(..., with_points=True)``: loss
  rtol 1e-5, every gradient within 1e-4 of its max, BN statistics 1e-5, three
  Adam steps and a resume from the JAX Adam state as ``test_torch_train.py``.
  From the second Adam step on, rounding noise in a gradient near zero is
  divided by that gradient's own running size, and on some frames it then
  spreads through BN to most weights within three steps: the port against
  itself on the same batch with its two frames swapped does the same.  The
  frames' seed is one of those (3 of 8 tried) on which three f32 steps of the
  two frameworks stay together;
* ``PerFrameDropout`` on its own: the property the JAX package has (a frame's
  mask depends on that frame's seed and the site alone), not its bits.

The JAX functions are compiled once per module; the caps overflow at the
coarse levels, so the child-sum chain and the scatter form meet a plan with
dropped subtrees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.data.pipeline import prepare_train_batch as jax_prepare_train_batch
from lidal_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from lidal_tpu.runtime import train as jtrain
from lidal_tpu.runtime.import_torch import convert_spvcnn_state_dict
from lidal_tpu_torch.data.pipeline import forward_batch, prepare_eval_batch, prepare_train_batch
from lidal_tpu_torch.models.layers import PerFrameDropout
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.runtime.train import TrainState, cross_entropy_ignore, make_optimizer, train_step
from lidal_tpu_torch.runtime.weights import (
    _to_torch,
    adam_state_from_jax,
    minkunet_state_dict_from_jax,
    spvcnn_state_dict_from_jax,
)
from tests import ts_oracle
from tests.test_torch_frames import surface_frames, torch_args
from tests.test_torch_minkunet import NARROW, _oracle_frames, _randomise_bn

CAPS = (512, 512, 256, 128, 32)
LR = 1e-3


@pytest.fixture(scope="module")
def frames():
    return surface_frames(84, b=2, p=512, n=480)


@pytest.fixture(scope="module")
def jax_run(frames):
    """A narrow JAX SPVCNN without dropout: the eval forward from variables with
    random BN, and from the initial state the gradients of one step and the
    states after 1, 2 and 3 Adam steps on the same batch."""
    xyz, sig, valid, labels = frames
    tb_j = jax_prepare_train_batch(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(xyz), jnp.asarray(sig), jnp.asarray(valid),
        jnp.asarray(labels), level_caps=CAPS, with_points=True, augment=False,
    )
    assert int(np.asarray(tb_j.overflow)[:, 1:].sum()) > 0
    model = JaxSPVCNN(num_classes=19, cs=NARROW, dropout_rate=0.0)
    tx = jtrain.make_optimizer()
    state0 = jtrain.init_state(model, jax.random.PRNGKey(1), tb_j, tx)

    eval_vars = _randomise_bn({"params": state0.params, "batch_stats": state0.batch_stats}, np.random.default_rng(2))
    logits_e, z3_e = jax.jit(model.apply, static_argnames="train")(
        eval_vars, tb_j.feats, tb_j.plan, tb_j.pplan, train=False
    )

    def loss_fn(params):
        (logits, _), upd = model.apply(
            {"params": params, "batch_stats": state0.batch_stats}, tb_j.feats, tb_j.plan, tb_j.pplan, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(3)},
        )
        return jtrain.cross_entropy_ignore(logits, tb_j.labels), upd["batch_stats"]

    (loss, stats1), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state0.params)
    step = jax.jit(jtrain.make_train_step(model, tx, with_points=True))
    states, losses = [state0], []
    for _ in range(3):
        st, lo = step(states[-1], tb_j, jax.random.PRNGKey(2))
        states.append(st)
        losses.append(float(lo))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {
        "eval_vars": eval_vars, "logits": np.asarray(logits_e), "z3": np.asarray(z3_e),
        "loss": float(loss), "grads": to_np(grads), "stats1": to_np(stats1), "losses": losses,
        "states": [jax.device_get(s) for s in states],
    }


def _train_batch(frames):
    return prepare_train_batch(None, *torch_args(*frames), level_caps=CAPS, augment=False, with_points=True)


def _port_state(jstate, with_adam: bool) -> TrainState:
    model = SPVCNN(num_classes=19, cs=NARROW, dropout_rate=0.0)
    model.load_state_dict(
        spvcnn_state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats}), strict=True
    )
    opt = make_optimizer(model)
    if with_adam:
        opt.load_state_dict(adam_state_from_jax(jstate.opt_state, model))
    return TrainState(step=int(jstate.step), model=model, optimizer=opt)


def _assert_params_close(model, jstate, what):
    want = spvcnn_state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    far, total = 0, 0
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 2 * LR, f"{what}: {name} off by {d.max()}"
        far += int((d > 1e-2 * LR).sum())
        total += d.size
    assert far <= 1e-3 * total, f"{what}: {far} of {total} entries differ by more than 1e-2 * lr"


def test_narrow_spvcnn_eval_matches_jax(frames, jax_run):
    model = SPVCNN(num_classes=19, cs=NARROW)
    sd = spvcnn_state_dict_from_jax(jax_run["eval_vars"])
    assert {f"point_transforms.{i}.{j}.weight" for i in range(3) for j in range(2)} <= set(sd)
    model.load_state_dict(sd, strict=True)
    model.eval()
    xyz, sig, valid, _ = frames
    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=CAPS, augment=False, with_points=True)
    with torch.inference_mode():
        logits, z3 = forward_batch(model, eb)
    assert logits.shape == (2, CAPS[0], 19) and z3.shape == (2, CAPS[0], NARROW[8])
    np.testing.assert_allclose(z3.numpy(), jax_run["z3"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), jax_run["logits"], rtol=1e-4, atol=1e-4)
    valid0 = eb.plan.levels[0].valid.numpy()
    assert valid0.any() and not logits.numpy()[~valid0].any() and not jax_run["logits"][~valid0].any()
    np.testing.assert_array_equal(logits.numpy().argmax(-1)[valid0], jax_run["logits"].argmax(-1)[valid0])


def test_state_dict_maps_refuse_the_other_family(jax_run):
    with pytest.raises(ValueError):
        spvcnn_state_dict_from_jax({"params": {"TorchLinear_0": {}}, "batch_stats": {}})
    trunk_only = minkunet_state_dict_from_jax(
        {k: {n: v for n, v in jax_run["eval_vars"][k].items() if not n.startswith("PointTransform")}
         for k in ("params", "batch_stats")}
    )
    assert not any(name.startswith("point_transforms") for name in trunk_only)
    with pytest.raises(RuntimeError):
        SPVCNN(num_classes=19, cs=NARROW).load_state_dict(trunk_only, strict=True)


def test_train_step_loss_grads_and_stats_match_jax(frames, jax_run):
    state = _port_state(jax_run["states"][0], with_adam=False)
    tb = _train_batch(frames)
    state.model.train()
    logits, _ = forward_batch(state.model, tb)
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
    assert all(np.abs(named[f"point_transforms.{i}.0.weight"].grad.numpy()).max() > 0 for i in range(3))

    stats = spvcnn_state_dict_from_jax({"params": jax_run["states"][0].params, "batch_stats": jax_run["stats1"]})
    for name, buf in state.model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_three_adam_steps_match_jax(frames, jax_run):
    state = _port_state(jax_run["states"][0], with_adam=False)
    tb = _train_batch(frames)
    for i in range(3):
        loss = train_step(state, tb, dropout_seeds=[5, 6])  # rate 0: the seeds draw nothing
        np.testing.assert_allclose(float(loss), jax_run["losses"][i], rtol=1e-5)
        _assert_params_close(state.model, jax_run["states"][i + 1], f"step {i + 1}")
    assert state.step == 3
    assert jax_run["losses"][2] < jax_run["losses"][0]


def test_adam_state_from_jax_continues_mid_training(frames, jax_run):
    jstate2 = jax_run["states"][2]
    state = _port_state(jstate2, with_adam=True)
    assert state.step == 2
    st = state.optimizer.state_dict()["state"]
    assert len(st) == len(list(state.model.parameters())) and float(st[0]["step"]) == 2.0
    loss = train_step(state, _train_batch(frames))
    np.testing.assert_allclose(float(loss), jax_run["losses"][2], rtol=1e-5)
    _assert_params_close(state.model, jax_run["states"][3], "resumed step 3")


def test_full_width_spvcnn_matches_reference_oracle():
    caps = (2048,) * 5  # lossless: the oracle has no capacities
    xyz, sig, valid = _oracle_frames()
    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=caps, augment=False, with_points=True)
    assert int(eb.overflow.sum()) == 0

    sd = ts_oracle.random_spvcnn_state_dict(np.random.default_rng(2))
    model = SPVCNN(num_classes=19)
    model.load_state_dict(spvcnn_state_dict_from_jax(convert_spvcnn_state_dict(sd)), strict=True)
    model.eval()
    with torch.inference_mode():
        logits, feat = forward_batch(model, eb)

    coords = eb.plan.levels[0].coords.numpy()
    valid0 = eb.plan.levels[0].valid.numpy()
    feats = eb.feats.numpy()
    cs, fs, rows = [], [], []
    for bi in range(coords.shape[0]):
        idx = np.where(valid0[bi])[0]
        rows.extend((bi, int(i)) for i in idx)
        cs.append(np.concatenate([coords[bi, idx], np.full((len(idx), 1), bi, coords.dtype)], axis=1))
        fs.append(feats[bi, idx])
    logits_o, feat_o = ts_oracle.Oracle(sd).spvcnn_forward(np.concatenate(cs), np.concatenate(fs))

    got_l = np.stack([logits[bi, ri].numpy() for bi, ri in rows])
    got_y = np.stack([feat[bi, ri].numpy() for bi, ri in rows])
    np.testing.assert_allclose(got_y, feat_o, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got_l, logits_o, rtol=2e-3, atol=2e-3)
    assert (got_l.argmax(1) == logits_o.argmax(1)).mean() > 0.999


def test_training_mode_with_dropout_runs_and_reaches_every_weight(frames):
    torch.manual_seed(0)
    model = SPVCNN(num_classes=19, cs=NARROW)  # dropout_rate 0.3, train mode
    tb = _train_batch(frames)
    logits, z3 = forward_batch(model, tb, dropout_seeds=[11, 12])
    again, _ = forward_batch(model, tb, dropout_seeds=[11, 12])
    other, _ = forward_batch(model, tb, dropout_seeds=[11, 13])
    valid0 = tb.plan.levels[0].valid
    assert bool(torch.isfinite(logits).all()) and not logits[~valid0].any()
    # BN's batch statistics couple the frames, so compare whole batches
    assert torch.equal(logits, again) and not torch.equal(logits, other)
    cross_entropy_ignore(logits, tb.labels).backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    with pytest.raises(ValueError):
        forward_batch(model, tb, dropout_seeds=[1, 2, 3])


# ---- PerFrameDropout --------------------------------------------------------------------


def test_dropout_is_identity_in_eval_and_at_rate_zero():
    x = torch.randn(3, 50, 8)
    assert PerFrameDropout(0.3).eval()(x, [1, 2, 3], 1) is x
    assert PerFrameDropout(0.0).train()(x, [1, 2, 3], 1) is x


def test_dropout_keeps_its_share_and_rescales():
    drop = PerFrameDropout(0.3).train()
    x = torch.ones(4, 4000, 16)
    y = drop(x, [7, 8, 9, 10], 1)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.full((), 1 / 0.7))
    assert all(abs(float(kept[b].float().mean()) - 0.7) < 0.02 for b in range(4))


def test_dropout_mask_of_a_frame_depends_on_its_seed_and_site_alone():
    drop = PerFrameDropout(0.3).train()
    x = torch.ones(3, 500, 8)
    seeds = [101, 202, 303]
    y = drop(x, seeds, 1)
    perm = [2, 0, 1]
    y_perm = drop(x, [seeds[i] for i in perm], 1)
    for new, old in enumerate(perm):
        assert torch.equal(y_perm[new], y[old])  # under a permuted batch
    assert torch.equal(drop(x[:1], seeds[1:2], 1)[0], y[1])  # and alone
    assert not torch.equal(drop(x, seeds, 2), y)  # the two sites differ
    assert not torch.equal(y[0], y[1])
    assert torch.equal(drop(x, torch.tensor(seeds), 1), y)  # seeds as a tensor


def test_dropout_without_seeds_draws_from_the_global_generator():
    drop = PerFrameDropout(0.5).train()
    x = torch.ones(2, 1000, 4)
    torch.manual_seed(3)
    a = drop(x, None, 1)
    torch.manual_seed(3)
    assert torch.equal(drop(x, None, 1), a)
    assert 0.4 < float((a != 0).float().mean()) < 0.6
