"""Port parity of the bf16 route (``lidal_tpu_torch/ops/conv.BF16_OPERANDS``,
the route's one switch) against the route the JAX package takes on
its TPU (``lidal_tpu/ops/conv.USE_PALLAS`` and
``ops/pallas_gather8.USE_PALLAS_BWD``), with the four Pallas kernels in
interpret mode, as ``tests/test_pallas_kernels.py`` runs them.  On the CPU
every routed call takes its kernel's plain bf16 version; ``test_torch_cuda.py``
holds the kernels against those on the card.

Inputs come from numpy seeds; m and n are multiples of 256 (Pallas tiles).

Tolerances:
* small integers (and quarter / half scale and shift): bit-equal, forward and
  backward, convs and ``gather8`` / ``scatter8``: every product and sum is
  exact in bf16 staging and in f32 on both sides;
* normal data, a conv's forward: 2**-8 of the abs-sum ``|bf16 x| @ |bf16 w|``
  (times ``|scale|`` with the epilogue): ``subm_conv_pallas`` rounds each tap's
  folded product ``x @ w[k]`` to bf16 (``pallas_conv.py:129-134``), the port's
  ``conv_gather_first`` keeps the sum in f32;
* normal data, a conv's backward (dx, dW) and ``scatter8``: 1e-5 of the
  abs-sum (f32 sums of exact products of bf16 values, in another order);
  ``gather8``: 1e-6 of ``sum |w8| |bf16 x|`` (eight rounded products added in
  another order when a row's taps lie in different 256-row blocks);
* whole narrow models on the route, eval: logits within ``LOGIT_SHARE`` of
  the JAX logits' largest magnitude, their rms difference within
  ``LOGIT_RMS`` of the JAX logits' rms and below the f32 route's (the port
  takes the JAX route's bf16 staging, not its per-tap rounding), argmax
  agreeing on ``ARGMAX_AGREE`` of the valid voxels.  Measured on these frames
  (``surface_frames(91)``; the model tests print their numbers, ``pytest -s``): 5.1e-4 / 9.8e-4 of the largest logit, rms 1.5e-4
  (the f32 route 3.2e-4 / 2.3e-4), argmax 1.0 / 0.997 (MinkUNet / SPVCNN);
* a train step on the route: loss within 1e-3 relative (measured 2.2e-4).
  Gradients at a narrow network's random start are dominated by the forward's
  rounding: BN over few voxels at the coarse levels cancels most of each
  gradient, and the JAX package's own f32 and Pallas routes differ by 38 % of
  the gradient's norm here (the port's f32 route equals JAX's f32 to 1e-6,
  ``test_torch_train.py``).  So the route's gradients are held to that
  distance: as one vector, no further from the JAX route's than
  ``GRAD_GLOBAL`` times the f32 route is (measured 0.94), each parameter no
  further than ``GRAD_EACH`` times (+ 1e-3 of its norm; measured at most 2.1),
  and the classifier's within 5e-2 of its norm (measured 1.5e-2).

The switch is off by default; off, no bf16 wrapper runs and the outputs stay
those of the f32 route; on, no f32 wrapper runs.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lidal_tpu.ops.conv as jconv
import lidal_tpu.ops.pallas_conv as pconv
import lidal_tpu.ops.pallas_gather8 as pg8
from lidal_tpu.data.pipeline import prepare_train_batch as jax_prepare_train_batch
from lidal_tpu.models import MinkUNet as JaxMinkUNet
from lidal_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from lidal_tpu.runtime import train as jtrain
from lidal_tpu_torch.data.pipeline import forward_batch, prepare_eval_batch, prepare_train_batch
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.ops import conv, cuda_conv, cuda_conv_bf16, cuda_conv_dxdw, cuda_conv_dxdw_fused, cuda_gather8
from lidal_tpu_torch.runtime.train import cross_entropy_ignore
from lidal_tpu_torch.runtime.weights import _to_torch, minkunet_state_dict_from_jax, spvcnn_state_dict_from_jax
from lidal_tpu_torch.utils import profiling
from tests.test_pallas_kernels import _int_feats, _sorted_nbr
from tests.test_torch_conv import CAPS, _call, _inputs, plan  # noqa: F401  (plan: the module's fixture)
from tests.test_torch_frames import surface_frames, torch_args
from tests.test_torch_minkunet import NARROW, _randomise_bn

MODEL_CAPS = (512, 256, 128, 128, 128)  # B = 2: every level's rows a multiple of 256
LOGIT_SHARE = 5e-3
LOGIT_RMS = 1e-3
ARGMAX_AGREE = 0.99
GRAD_GLOBAL = 1.5
GRAD_EACH = 4.0

_PALLAS = {
    (pconv, "subm_conv_pallas"): pconv.subm_conv_pallas,
    (pconv, "conv_dx_dw_pallas"): pconv.conv_dx_dw_pallas,
    (pg8, "gather8_pallas"): pg8.gather8_pallas,
    (pg8, "scatter8_pallas"): pg8.scatter8_pallas,
}


@contextlib.contextmanager
def jax_pallas_route():
    """The JAX package's TPU route on the CPU: both switches on, each Pallas
    kernel in interpret mode."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(jconv, "USE_PALLAS", True))
        stack.enter_context(mock.patch.object(pg8, "USE_PALLAS_BWD", True))
        for (mod, name), fn in _PALLAS.items():
            stack.enter_context(mock.patch.object(mod, name, functools.partial(fn, interpret=True)))
        yield


# ---- the routed ops -------------------------------------------------------------------------------


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("epilogue", [None, False, True])  # None: the train forward; False / True: eval BN, relu
@pytest.mark.parametrize("kind,cin,cout", [("subm", 4, 32), ("subm", 16, 64), ("down", 32, 64), ("up", 64, 32)])
def test_routed_conv_forward_matches_pallas_interpret(plan, kind, cin, cout, epilogue, integer):  # noqa: F811
    rng = np.random.default_rng([cin, cout, 0 if epilogue is None else 1 + epilogue, integer])
    x, w, scale, shift = _inputs(rng, kind, cin, cout, integer)
    if epilogue is None:
        args = _train_conv_args(plan, kind)
        with jax_pallas_route():
            want = np.asarray(getattr(jconv, f"{kind}_conv_batched")(jnp.asarray(x), jnp.asarray(w), *map(jnp.asarray, args)))
        with conv.bf16_route():
            got = getattr(conv, f"{kind}_conv_batched")(torch.from_numpy(x), torch.from_numpy(w), *map(torch.from_numpy, args))
    else:
        with jax_pallas_route():
            want = np.asarray(_call(kind, jconv, plan, x, w, scale, shift, epilogue))
        with conv.bf16_route():
            got = _call(kind, conv, plan, x, w, scale, shift, epilogue)
    got = got.numpy()
    assert got.shape == want.shape
    if integer:
        np.testing.assert_array_equal(got, want)
        return
    # |bf16 x| @ |bf16 w| through the port's f32 route, times |scale| with the epilogue
    bx, bw = (torch.from_numpy(a).to(torch.bfloat16).float().abs() for a in (x, w))
    ones = torch.ones(cout)
    if epilogue is None:
        abs_sum = getattr(conv, f"{kind}_conv_batched")(bx, bw, *map(torch.from_numpy, args)).numpy()
    else:
        abs_sum = _call(kind, conv, plan, bx.numpy(), bw.numpy(), ones.numpy(), 0 * ones.numpy(), False).numpy()
        abs_sum = abs_sum * np.abs(scale)
    assert (np.abs(got - want) <= 2.0**-8 * abs_sum + 1e-7).all(), float(np.abs(got - want).max())
    # the route is bf16, not f32: the f32 route differs on the same inputs
    if epilogue is None:
        f32 = getattr(conv, f"{kind}_conv_batched")(torch.from_numpy(x), torch.from_numpy(w), *map(torch.from_numpy, args))
    else:
        f32 = _call(kind, conv, plan, x, w, scale, shift, epilogue)
    assert np.abs(f32.numpy() - got).max() > 1e-4


def _train_conv_args(plan, kind):  # noqa: F811
    """The map arguments of ``{kind}_conv_batched`` at level 0 / 1 of ``plan``."""
    if kind == "subm":
        return (plan.levels[0].nbr3.numpy(),)
    d = plan.downs[0]
    return d.child.numpy(), d.parent.numpy(), d.pdelta.numpy()


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("kind,cin,cout,need_dx", [
    ("subm", 4, 32, False),  # the stem: dW alone
    ("subm", 16, 32, True), ("down", 32, 64, True), ("up", 64, 32, True),
])
def test_routed_conv_backward_matches_pallas_interpret(plan, kind, cin, cout, need_dx, integer):  # noqa: F811
    """dx and dW of the three convs through ``conv_dx_dw_fused`` (the stem:
    dW alone, ``need_dx=False``) against ``conv_dx_dw_pallas`` in the JAX
    custom VJPs."""
    rng = np.random.default_rng([cin, cout, integer, 7])
    x, w, _, _ = _inputs(rng, kind, cin, cout, integer)
    args = _train_conv_args(plan, kind)
    out_rows = {"subm": CAPS[0], "down": CAPS[1], "up": CAPS[0]}[kind]
    dy = (_int_feats(rng, 2 * out_rows, cout).reshape(2, out_rows, cout) if integer
          else rng.standard_normal((2, out_rows, cout)).astype(np.float32))
    fn_j = getattr(jconv, f"{kind}_conv_batched")
    with jax_pallas_route():
        _, vjp = jax.vjp(lambda xx, ww: fn_j(xx, ww, *map(jnp.asarray, args)), jnp.asarray(x), jnp.asarray(w))
        dx_j, dw_j = (np.asarray(a) for a in vjp(jnp.asarray(dy)))

    def port_grads(xa, wa, dya, route):
        xt = torch.from_numpy(xa).requires_grad_(need_dx)
        wt = torch.from_numpy(wa).requires_grad_(True)
        with route():
            out = getattr(conv, f"{kind}_conv_batched")(xt, wt, *map(torch.from_numpy, args))
            out.backward(torch.from_numpy(dya))
        return (xt.grad.numpy() if need_dx else None), wt.grad.numpy()

    calls = {"fused": 0}
    fused = cuda_conv_dxdw_fused.conv_dx_dw_fused

    def counting(*a, **kw):
        calls["fused"] += 1
        assert kw.get("need_dx", a[5] if len(a) > 5 else True) == need_dx
        return fused(*a, **kw)

    with mock.patch.object(cuda_conv_dxdw_fused, "conv_dx_dw_fused", counting):
        dx, dw = port_grads(x, w, dy, conv.bf16_route)
    assert calls["fused"] == 1
    if integer:
        np.testing.assert_array_equal(dw, dw_j)
        if need_dx:
            np.testing.assert_array_equal(dx, dx_j)
        return
    # abs-sums: the f32 route's gradients of |x|, |w| under |dy|
    abs_dx, abs_dw = port_grads(np.abs(x), np.abs(w), np.abs(dy), contextlib.nullcontext)
    assert (np.abs(dw - dw_j) <= 1e-5 * abs_dw + 1e-7).all(), float(np.abs(dw - dw_j).max())
    if need_dx:
        assert (np.abs(dx - dx_j) <= 1e-5 * abs_dx + 1e-7).all(), float(np.abs(dx - dx_j).max())


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("seed,n,m,c,density", [(70, 256, 512, 32, 0.8), (71, 512, 256, 64, 0.5), (72, 256, 256, 8, 0.0)])
def test_routed_gather8_and_scatter8_match_pallas_interpret(seed, n, m, c, density, integer):
    """``gather8`` with its bf16 table and its backward ``scatter8`` on bf16
    ``dy`` and bf16-rounded ``w8`` against ``gather8_pallas`` / ``scatter8_pallas``
    through the JAX ``gather8``'s custom VJP.  The argument alone picks the
    route of both, with ``conv.BF16_OPERANDS`` off."""
    rng = np.random.default_rng(seed)
    nbr = _sorted_nbr(rng, m, 8, n, density)
    if integer:
        feats, dy = _int_feats(rng, n, c), _int_feats(rng, m, c)
        w8 = (rng.integers(0, 5, size=(m, 8)) / 4.0).astype(np.float32)
    else:
        feats, dy = rng.standard_normal((n, c)).astype(np.float32), rng.standard_normal((m, c)).astype(np.float32)
        w8 = rng.random((m, 8)).astype(np.float32)
    with jax_pallas_route():
        out_j, vjp = jax.vjp(lambda f: pg8.gather8(f, jnp.asarray(nbr), jnp.asarray(w8)), jnp.asarray(feats))
        out_j, (df_j,) = np.asarray(out_j), vjp(jnp.asarray(dy))
    ft = torch.from_numpy(feats).requires_grad_(True)
    out = cuda_gather8.gather8(ft, torch.from_numpy(nbr), torch.from_numpy(w8), bf16=True)  # the switch stays off
    out.backward(torch.from_numpy(dy))
    got, df = out.detach().numpy(), ft.grad.numpy()
    if integer:
        np.testing.assert_array_equal(got, out_j)
        np.testing.assert_array_equal(df, np.asarray(df_j))
        return
    tn, tw = torch.from_numpy(nbr), torch.from_numpy(w8)
    abs_out = cuda_gather8.gather8_plain(torch.from_numpy(feats).abs(), tn, tw, True).numpy()
    abs_df = cuda_gather8.scatter8_plain(torch.from_numpy(dy).abs(), tn, tw.abs(), n, True).numpy()
    assert (np.abs(got - out_j) <= 1e-6 * abs_out).all(), float(np.abs(got - out_j).max())
    assert (np.abs(df - np.asarray(df_j)) <= 1e-5 * abs_df).all(), float(np.abs(df - np.asarray(df_j)).max())
    if density:  # the rounding is there: the f32 versions differ
        assert np.abs(cuda_gather8.gather8_plain(torch.from_numpy(feats), tn, tw).numpy() - got).max() > 1e-4
        assert np.abs(cuda_gather8.scatter8_plain(torch.from_numpy(dy), tn, tw, n).numpy() - df).max() > 1e-4


# ---- whole narrow models --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    return surface_frames(91, b=2, p=512, n=480)


def _jax_batch(frames, with_points):
    xyz, sig, valid, labels = frames
    return jax_prepare_train_batch(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(xyz), jnp.asarray(sig), jnp.asarray(valid),
        jnp.asarray(labels), level_caps=MODEL_CAPS, with_points=with_points, augment=False,
    )


def _rms(a, valid0):
    return float(np.sqrt((a[valid0] ** 2).mean()))


def _assert_logits_close(got, f32, want, valid0, what):
    share = float(np.abs(got - want).max() / np.abs(want).max())
    rms, rms_f32 = _rms(got - want, valid0) / _rms(want, valid0), _rms(f32 - want, valid0) / _rms(want, valid0)
    agree = float((got.argmax(-1) == want.argmax(-1))[valid0].mean())
    print(f"{what}: max |d| / max |JAX| {share:.2e}, rms {rms:.2e} (f32 route {rms_f32:.2e}), argmax agreement {agree:.4f}")
    assert share <= LOGIT_SHARE, f"{what}: logits differ by {share:.3e} of their largest magnitude"
    assert rms <= LOGIT_RMS and rms < rms_f32, f"{what}: rms difference {rms:.3e} (the f32 route {rms_f32:.3e})"
    assert agree >= ARGMAX_AGREE, f"{what}: argmax agreement {agree:.4f}"
    assert not got[~valid0].any() and not want[~valid0].any()


@pytest.mark.parametrize("family", ["Mink", "SPVCNN"])
def test_narrow_model_eval_on_the_route_matches_pallas_interpret(frames, family):
    """The eval forward (fused conv + BN epilogues; for SPVCNN the bf16
    ``gather8`` of both point transfers) on the route against the JAX
    package's, from the same variables with random BN."""
    spv = family == "SPVCNN"
    tb_j = _jax_batch(frames, spv)
    jmodel = JaxSPVCNN(num_classes=19, cs=NARROW, dropout_rate=0.0) if spv else JaxMinkUNet(num_classes=19, cs=NARROW)
    extra = (tb_j.pplan,) if spv else ()
    variables = jax.jit(jmodel.init, static_argnames="train")(jax.random.PRNGKey(1), tb_j.feats, tb_j.plan, *extra,
                                                              train=False)
    variables = _randomise_bn(variables, np.random.default_rng(2))
    with jax_pallas_route():
        logits_j, _ = jax.jit(jmodel.apply, static_argnames="train")(variables, tb_j.feats, tb_j.plan, *extra,
                                                                     train=False)
    logits_j = np.asarray(logits_j)

    model = SPVCNN(num_classes=19, cs=NARROW) if spv else MinkUNet(num_classes=19, cs=NARROW)
    model.load_state_dict((spvcnn_state_dict_from_jax if spv else minkunet_state_dict_from_jax)(variables), strict=True)
    model.eval()
    xyz, sig, valid, _ = frames
    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=MODEL_CAPS, augment=False, with_points=spv)
    with torch.inference_mode():
        with conv.bf16_route():
            logits, _ = forward_batch(model, eb)
        f32, _ = forward_batch(model, eb)
    valid0 = eb.plan.levels[0].valid.numpy()
    assert valid0.any() and logits.shape == logits_j.shape
    _assert_logits_close(logits.numpy(), f32.numpy(), logits_j, valid0, family)


def test_minkunet_train_step_on_the_route_matches_pallas_interpret(frames):
    """One MinkUNet train step (batch-statistics BN, the convs' forward on
    ``conv_gather_first``, their backward on ``conv_dx_dw_fused``, the stem's
    dW alone) against ``jax.value_and_grad`` on the JAX route, from the
    same variables carried across by ``runtime/weights.py``."""
    tb_j = _jax_batch(frames, False)
    jmodel = JaxMinkUNet(num_classes=19, cs=NARROW)
    state0 = jtrain.init_state(jmodel, jax.random.PRNGKey(1), tb_j, jtrain.make_optimizer())

    def loss_fn(params):
        (logits, _), upd = jmodel.apply({"params": params, "batch_stats": state0.batch_stats}, tb_j.feats, tb_j.plan,
                                        train=True, mutable=["batch_stats"])
        return jtrain.cross_entropy_ignore(logits, tb_j.labels)

    with jax_pallas_route():
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(state0.params)
    want_g = _to_torch(jax.tree_util.tree_map(np.asarray, grads_j))

    tb = prepare_train_batch(None, *torch_args(*frames), level_caps=MODEL_CAPS, augment=False)

    def port_step(route):
        model = MinkUNet(num_classes=19, cs=NARROW)
        model.load_state_dict(minkunet_state_dict_from_jax({"params": state0.params, "batch_stats": state0.batch_stats}),
                              strict=True)
        model.train()
        with route():
            logits, _ = model(tb.feats, tb.plan)
            loss = cross_entropy_ignore(logits, tb.labels)
            loss.backward()
        return float(loss.detach()), {n: p.grad.numpy() for n, p in model.named_parameters()}

    launches = profiling.counter("launch.conv_dx_dw_fused")
    loss, grads = port_step(conv.bf16_route)
    assert profiling.counter("launch.conv_dx_dw_fused") == launches  # the CPU takes the plain versions: no launch
    _, grads_f32 = port_step(contextlib.nullcontext)
    np.testing.assert_allclose(loss, float(loss_j), rtol=1e-3)
    assert sorted(grads) == sorted(want_g)
    assert all(np.abs(g).max() > 0 for n, g in grads.items() if n.endswith("kernel"))
    names = [n for n in grads if np.abs(want_g[n].numpy()).max() > 0]  # a bias in front of a BN has none
    dist = {n: float(np.linalg.norm(grads[n] - want_g[n].numpy())) for n in names}
    dist_f32 = {n: float(np.linalg.norm(grads_f32[n] - want_g[n].numpy())) for n in names}
    norm = {n: float(np.linalg.norm(want_g[n].numpy())) for n in names}
    total, total_f32 = (float(np.sqrt(sum(d[n] ** 2 for n in names))) for d in (dist, dist_f32))
    whole = float(np.sqrt(sum(norm[n] ** 2 for n in names)))
    print(f"loss {loss:.6f} against {float(loss_j):.6f}; gradients {total / whole:.3f} of their norm from the JAX "
          f"route's (the f32 route {total_f32 / whole:.3f}), each parameter at most "
          f"{max(dist[n] / max(dist_f32[n], 1e-30) for n in names):.2f}x the f32 route's distance, the classifier's "
          f"weight {dist['classifier.0.weight'] / norm['classifier.0.weight']:.2e} of its norm")
    assert total <= GRAD_GLOBAL * total_f32, f"gradients {total:.3e} from the JAX route's, the f32 route {total_f32:.3e}"
    for n in names:
        assert dist[n] <= GRAD_EACH * dist_f32[n] + 1e-3 * norm[n], f"{n}: {dist[n]:.3e} against {dist_f32[n]:.3e}"
    for n in ("classifier.0.weight", "classifier.0.bias"):
        assert dist[n] <= 5e-2 * norm[n], f"{n}: {dist[n] / norm[n]:.3e} of its norm"


# ---- the switch ------------------------------------------------------------------------------------


def _forbid(mod, name, what):
    def refuse(*a, **kw):
        raise AssertionError(f"{what}: {mod.__name__}.{name} was called")

    return mock.patch.object(mod, name, refuse)


def _f32_wrappers_forbidden():
    stack = contextlib.ExitStack()
    stack.enter_context(_forbid(cuda_conv, "subm_conv", "the bf16 route"))
    stack.enter_context(_forbid(cuda_conv_dxdw, "conv_dx_dw", "the bf16 route"))
    return stack


def _bf16_wrappers_forbidden():
    stack = contextlib.ExitStack()
    stack.enter_context(_forbid(cuda_conv_bf16, "conv_gather_first", "the f32 route"))
    stack.enter_context(_forbid(cuda_conv_dxdw_fused, "conv_dx_dw_fused", "the f32 route"))
    return stack


def _spvcnn_step(frames, seed=5):
    """Logits and every gradient of one narrow SPVCNN train step (dropout
    off) from weights of ``seed``."""
    torch.manual_seed(seed)
    model = SPVCNN(num_classes=19, cs=NARROW, dropout_rate=0.0).train()
    tb = prepare_train_batch(None, *torch_args(*frames), level_caps=MODEL_CAPS, augment=False, with_points=True)
    logits, _ = forward_batch(model, tb)
    cross_entropy_ignore(logits, tb.labels).backward()
    return [logits.detach()] + [p.grad for p in model.parameters()]


def test_switch_is_off_by_default_and_flipping_it_changes_nothing_else(frames):
    """Off (the default) no bf16 wrapper runs; on, no f32 conv wrapper runs and
    gather8 / scatter8 take their bf16 rows; off again, the outputs are
    bit-equal to those before it was on."""
    assert conv.BF16_OPERANDS is False
    flags = {"gather8": [], "scatter8": []}
    g8, s8 = cuda_gather8.gather8_forward, cuda_gather8.scatter8

    def g8_rec(*a, **kw):
        flags["gather8"].append(bool(a[3]) if len(a) > 3 else kw.get("bf16_table", False))
        return g8(*a, **kw)

    def s8_rec(*a, **kw):
        flags["scatter8"].append(bool(a[4]) if len(a) > 4 else kw.get("bf16", False))
        return s8(*a, **kw)

    with mock.patch.object(cuda_gather8, "gather8_forward", g8_rec), mock.patch.object(cuda_gather8, "scatter8", s8_rec):
        with _bf16_wrappers_forbidden():
            before = _spvcnn_step(frames)
        assert flags["gather8"] and not any(flags["gather8"]) and flags["scatter8"] and not any(flags["scatter8"])
        flags["gather8"].clear(), flags["scatter8"].clear()
        with _f32_wrappers_forbidden(), conv.bf16_route():
            on = _spvcnn_step(frames)
        assert all(flags["gather8"]) and all(flags["scatter8"]) and len(flags["scatter8"]) == 2
        with _bf16_wrappers_forbidden():
            after = _spvcnn_step(frames)
    assert conv.BF16_OPERANDS is False
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not torch.equal(on[0], before[0])  # the route changed the numbers
