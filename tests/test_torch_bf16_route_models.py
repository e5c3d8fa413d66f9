"""The bf16 route (``lidal_tpu_torch/ops/conv.bf16_route``) on the model
paths the JAX package runs on its Pallas route and
``tests/test_torch_bf16_route.py`` does not hold: one SPVCNN train step, and
narrow nuScenes models (16 classes, nuScenes-like frames), MinkUNet and
SPVCNN eval, each against the JAX package's route with the Pallas kernels in
interpret mode (``tests/test_torch_bf16_route.jax_pallas_route``), from the
same variables carried across by ``runtime/weights.py``.  A file apart from
``tests/test_torch_bf16_paths.py`` (the command line, rounds and ranks on
the route), so that ``--dist loadfile`` runs the two side by side.

Tolerances, those of ``tests/test_torch_bf16_route.py``: eval logits within
``LOGIT_SHARE`` of the largest JAX logit, their rms difference within
``LOGIT_RMS`` of the JAX logits' rms and below the f32 route's, argmax
agreeing on ``ARGMAX_AGREE`` of the valid voxels; a train step's loss within
1e-3 relative, its gradients no further from the JAX route's than
``GRAD_GLOBAL`` (as one vector) and ``GRAD_EACH`` (each parameter, + 1e-3 of
its norm) times the f32 route's, the classifier's within 5e-2 of its norm.
Measured here (``pytest -s`` prints them): the SPVCNN step's loss 8e-5
relative, gradients 0.297 of their norm from the JAX route's (the f32 route
0.288), each parameter at most 2.02x the f32 route's distance, the
classifier 9.8e-3; NU MinkUNet / SPVCNN logits 5.4e-4 / 8.7e-4 of the
largest, rms 1.3e-4 / 1.3e-4 (the f32 route 2.2e-4 / 1.8e-4), argmax
0.9987 / 1.0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.data.pipeline import prepare_train_batch as jax_prepare_train_batch
from lidal_tpu.models import MinkUNet as JaxMinkUNet
from lidal_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from lidal_tpu.runtime import train as jtrain
from lidal_tpu_torch.data.pipeline import forward_batch, prepare_eval_batch, prepare_train_batch
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.ops import conv
from lidal_tpu_torch.runtime.train import cross_entropy_ignore
from lidal_tpu_torch.runtime.weights import _to_torch, minkunet_state_dict_from_jax, spvcnn_state_dict_from_jax
from tests.test_torch_bf16_paths import MODELS, wrapper_calls
from tests.test_torch_bf16_route import GRAD_EACH, GRAD_GLOBAL, MODEL_CAPS, _assert_logits_close, jax_pallas_route
from tests.test_torch_frames import surface_frames, torch_args
from tests.test_torch_minkunet import NARROW, _randomise_bn

NU_CLASSES = 16
@pytest.fixture(scope="module")
def frames():
    return surface_frames(91, b=2, p=512, n=480)  # tests/test_torch_bf16_route.py's


def _jax_batch(frames, with_points, caps=MODEL_CAPS):
    xyz, sig, valid, labels = frames
    return jax_prepare_train_batch(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(xyz), jnp.asarray(sig), jnp.asarray(valid),
        jnp.asarray(labels), level_caps=caps, with_points=with_points, augment=False,
    )


def test_spvcnn_train_step_on_the_route_matches_pallas_interpret(frames):
    """One SPVCNN train step (dropout off: JAX's streams cannot be replayed)
    on the route, from the variables of the JAX route's step carried across
    by ``runtime/weights.py``: the convs on ``conv_gather_first`` and
    ``conv_dx_dw_fused``, both point transfers on ``gather8`` and
    ``child_sum`` over bf16 rows and ``gather8``'s backward on ``scatter8``
    over bf16 ``dy``, against ``jax.value_and_grad`` on the JAX route.  The
    tolerances of the MinkUNet step (``tests/test_torch_bf16_route.py``):
    loss within 1e-3 relative, gradients within ``GRAD_GLOBAL`` /
    ``GRAD_EACH`` times the f32 route's distance, the classifier within 5e-2
    of its norm.  The Linear biases in front of the point branch's BNs have a
    zero gradient by construction (the BN removes them), so what they hold
    is rounding noise and is not compared."""
    tb_j = _jax_batch(frames, True)
    jmodel = JaxSPVCNN(num_classes=19, cs=NARROW, dropout_rate=0.0)
    state0 = jtrain.init_state(jmodel, jax.random.PRNGKey(1), tb_j, jtrain.make_optimizer())

    def loss_fn(params):
        (logits, _), _ = jmodel.apply({"params": params, "batch_stats": state0.batch_stats}, tb_j.feats, tb_j.plan,
                                      tb_j.pplan, train=True, mutable=["batch_stats"],
                                      rngs={"dropout": jax.random.PRNGKey(3)})
        return jtrain.cross_entropy_ignore(logits, tb_j.labels)

    with jax_pallas_route():
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(state0.params)
    want_g = _to_torch(jax.tree_util.tree_map(np.asarray, grads_j))
    tb = prepare_train_batch(None, *torch_args(*frames), level_caps=MODEL_CAPS, augment=False, with_points=True)
    variables = spvcnn_state_dict_from_jax({"params": state0.params, "batch_stats": state0.batch_stats})

    def port_step(route):
        model = SPVCNN(num_classes=19, cs=NARROW, dropout_rate=0.0)
        model.load_state_dict(variables, strict=True)
        model.train()
        with wrapper_calls(route) as calls, conv.bf16_route(route):
            logits, _ = forward_batch(model, tb)
            loss = cross_entropy_ignore(logits, tb.labels)
            loss.backward()
        assert {"gather8_forward", "child_sum", "scatter8"} <= set(calls), calls
        return float(loss.detach()), {n: p.grad.numpy() for n, p in model.named_parameters()}

    loss, grads = port_step(True)
    _, grads_f32 = port_step(False)
    np.testing.assert_allclose(loss, float(loss_j), rtol=1e-3)
    assert sorted(grads) == sorted(want_g)
    assert all(np.abs(g).max() > 0 for n, g in grads.items() if n.endswith("kernel"))
    noise = {f"point_transforms.{i}.0.bias" for i in range(3)}
    names = [n for n in grads if n not in noise]
    dist_ = {n: float(np.linalg.norm(grads[n] - want_g[n].numpy())) for n in names}
    dist_f32 = {n: float(np.linalg.norm(grads_f32[n] - want_g[n].numpy())) for n in names}
    norm = {n: float(np.linalg.norm(want_g[n].numpy())) for n in names}
    total, total_f32 = (float(np.sqrt(sum(d[n] ** 2 for n in names))) for d in (dist_, dist_f32))
    whole = float(np.sqrt(sum(norm[n] ** 2 for n in names)))
    print(f"loss {loss:.6f} against {float(loss_j):.6f}; gradients {total / whole:.3f} of their norm from the JAX "
          f"route's (the f32 route {total_f32 / whole:.3f}), each parameter at most "
          f"{max(dist_[n] / max(dist_f32[n], 1e-30) for n in names):.2f}x the f32 route's distance, the classifier's "
          f"weight {dist_['classifier.0.weight'] / norm['classifier.0.weight']:.2e} of its norm")
    assert total <= GRAD_GLOBAL * total_f32, f"gradients {total:.3e} from the JAX route's, the f32 route {total_f32:.3e}"
    for n in names:
        assert dist_[n] <= GRAD_EACH * dist_f32[n] + 1e-3 * norm[n], f"{n}: {dist_[n]:.3e} against {dist_f32[n]:.3e}"
    for n in ("classifier.0.weight", "classifier.0.bias"):
        assert dist_[n] <= 5e-2 * norm[n], f"{n}: {dist_[n] / norm[n]:.3e} of its norm"


def nu_frames(seed=93):
    """nuScenes-like frames (a 32-beam sweep: fewer points over a wider span
    than ``frames``), labels of NU's 16 classes; with MODEL_CAPS at B = 2
    every level's rows are a multiple of 256, so the JAX package takes its
    Pallas route at every conv."""
    xyz, sig, valid, labels = surface_frames(seed, b=2, p=512, n=400, span=12.0)
    return xyz, sig, valid, np.where(valid, labels % NU_CLASSES, labels)


@pytest.mark.parametrize("family", MODELS)
def test_nu_narrow_model_eval_on_the_route_matches_pallas_interpret(family):
    """Narrow NU models (16 classes) on nuScenes-like frames: the eval forward
    on the route against the JAX package's route, from the same variables
    with random BN; tolerances as ``tests/test_torch_bf16_route.py``'s
    narrow SemanticKITTI models (``LOGIT_SHARE``, ``LOGIT_RMS`` and below the
    f32 route's rms, ``ARGMAX_AGREE``)."""
    spv = family == "SPVCNN"
    frames_nu = nu_frames()
    tb_j = _jax_batch(frames_nu, spv)
    jmodel = (JaxSPVCNN(num_classes=NU_CLASSES, cs=NARROW, dropout_rate=0.0) if spv
              else JaxMinkUNet(num_classes=NU_CLASSES, cs=NARROW))
    extra = (tb_j.pplan,) if spv else ()
    variables = jax.jit(jmodel.init, static_argnames="train")(jax.random.PRNGKey(1), tb_j.feats, tb_j.plan, *extra,
                                                              train=False)
    variables = _randomise_bn(variables, np.random.default_rng(2))
    with jax_pallas_route():
        logits_j, _ = jax.jit(jmodel.apply, static_argnames="train")(variables, tb_j.feats, tb_j.plan, *extra,
                                                                     train=False)
    logits_j = np.asarray(logits_j)

    model = SPVCNN(num_classes=NU_CLASSES, cs=NARROW) if spv else MinkUNet(num_classes=NU_CLASSES, cs=NARROW)
    model.load_state_dict((spvcnn_state_dict_from_jax if spv else minkunet_state_dict_from_jax)(variables), strict=True)
    model.eval()
    xyz, sig, valid, _ = frames_nu
    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=MODEL_CAPS, augment=False, with_points=spv)
    with torch.inference_mode():
        with wrapper_calls(True) as calls, conv.bf16_route():
            logits, _ = forward_batch(model, eb)
        f32, _ = forward_batch(model, eb)
    assert calls["conv_gather_first"] == 42 and calls["gather8_forward"] == calls["child_sum"] == (2 if spv else 0)
    valid0 = eb.plan.levels[0].valid.numpy()
    assert valid0.any() and logits.shape == logits_j.shape == (2, MODEL_CAPS[0], NU_CLASSES)
    _assert_logits_close(logits.numpy(), f32.numpy(), logits_j, valid0, f"NU {family}")
