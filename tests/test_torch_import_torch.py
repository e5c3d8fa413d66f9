"""The port's checkpoint import (``lidal_tpu_torch/runtime/import_torch.py``,
``cli/commands.import_torch_command``) against the JAX package's, CPU.

* ``convert_*_state_dict`` of a reference-layout (torchsparse-1.4) state dict,
  with and without DDP's ``module.`` prefix and with BatchNorm's
  ``num_batches_tracked``, equals the JAX package's ``convert_*`` carried into
  the port by ``runtime/weights.*_state_dict_from_jax``, bit for bit, and
  loads strictly into the full-width model;
* ``export_*`` then ``convert_*`` returns the model's state dict, and
  ``convert_*`` then ``export_*`` returns the reference-layout dict;
* ``import_torch_command`` writes ``current_port.pt`` holding the weights,
  ``step = iteration``, the checkpoint's ``ep_id`` and a fresh Adam, for
  SemanticKITTI and nuScenes, and ``_load_eval_variables`` restores it;
* a narrow model exported to a ``current.pt`` and read back by both packages'
  ``load_torch_checkpoint``: the port's logits bit-equal to the source model's
  and within 1e-4 of the JAX package's model, MinkUNet and SPVCNN.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidal_tpu.models import MinkUNet as JaxMinkUNet
from lidal_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from lidal_tpu.ops import devoxelize as jdv
from lidal_tpu.ops import kernel_map as jkm
from lidal_tpu.runtime import import_torch as jimport
from lidal_tpu_torch import config
from lidal_tpu_torch.cli import commands
from lidal_tpu_torch.data.pipeline import forward_batch, prepare_eval_batch
from lidal_tpu_torch.models.layers import MaskedBatchNorm
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.models.spvcnn import SPVCNN
from lidal_tpu_torch.ops import kernel_map
from lidal_tpu_torch.runtime import checkpoint as ckpt
from lidal_tpu_torch.runtime import import_torch
from lidal_tpu_torch.runtime.paths import Paths
from lidal_tpu_torch.runtime.train_loop import init_state
from lidal_tpu_torch.runtime.weights import minkunet_state_dict_from_jax, spvcnn_state_dict_from_jax
from tests import ts_oracle
from tests.test_torch_frames import surface_frames, torch_args
from tests.test_torch_minkunet import NARROW

FAMILIES = {
    "Mink": (ts_oracle.random_minkunet_state_dict, import_torch.convert_minkunet_state_dict,
             import_torch.export_minkunet_state_dict, jimport.convert_minkunet_state_dict,
             minkunet_state_dict_from_jax, MinkUNet),
    "SPVCNN": (ts_oracle.random_spvcnn_state_dict, import_torch.convert_spvcnn_state_dict,
               import_torch.export_spvcnn_state_dict, jimport.convert_spvcnn_state_dict,
               spvcnn_state_dict_from_jax, SPVCNN),
}


def _reference_sd(family, seed, num_classes=16):
    """A random reference-layout state dict as torch tensors, with BatchNorm's
    ``num_batches_tracked`` beside every running mean."""
    sd = {k: torch.from_numpy(v) for k, v in FAMILIES[family][0](np.random.default_rng(seed), num_classes).items()}
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(1000, dtype=torch.int64)
    return sd


@pytest.mark.parametrize("prefix", ["", "module."])
@pytest.mark.parametrize("family", ["Mink", "SPVCNN"])
def test_convert_equals_jax_convert_then_weights_map(family, prefix):
    _, convert, _, jax_convert, from_jax, cls = FAMILIES[family]
    sd = _reference_sd(family, 1)
    got = convert({prefix + k: v for k, v in sd.items()})
    want = from_jax(jax_convert({prefix + k: v.numpy() for k, v in sd.items()}))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    model = cls(num_classes=16)
    model.load_state_dict(got, strict=True)
    assert sorted(model.state_dict()) == sorted(got)


@pytest.mark.parametrize("family", ["Mink", "SPVCNN"])
def test_export_and_convert_round_trip(family):
    _, convert, export, _, _, cls = FAMILIES[family]
    torch.manual_seed(2)
    state = cls(num_classes=16).state_dict()
    back = convert(export(state))
    assert back.keys() == state.keys() and all(torch.equal(back[k], state[k]) for k in state)
    sd = {k: v for k, v in _reference_sd(family, 3).items() if not k.endswith("num_batches_tracked")}
    again = export(convert(sd))
    assert again.keys() == sd.keys() and all(torch.equal(again[k], sd[k]) for k in sd)
    assert again["stage2.1.downsample.0.kernel"].ndim == 2  # ks=1 kernels as [cin, cout]
    if family == "Mink":
        with pytest.raises(ValueError, match="point transforms"):
            import_torch.convert_spvcnn_state_dict(sd)
    # converted taps follow the port's offsets: torchsparse-1.4's odd kernels permuted, even ones as they are
    taps3 = import_torch._conv_w(torch.arange(27.0)[:, None, None]).flatten().long().tolist()
    assert [import_torch.TS14_OFFSETS_ODD3[t] for t in taps3] == list(kernel_map.OFFSETS3)
    taps2 = import_torch._conv_w(torch.arange(8.0)[:, None, None]).flatten().long().tolist()
    assert [import_torch.TS14_OFFSETS_EVEN2[t] for t in taps2] == list(kernel_map.OFFSETS2)


@pytest.mark.parametrize("dataset,family", [("SK", "Mink"), ("NU", "Mink"), ("NU", "SPVCNN")])
def test_import_torch_command_restores_step_and_fresh_adam(tmp_path, dataset, family):
    cfg = config.RunConfig(dataset_name=dataset, model_name=family, checkpoint_root=str(tmp_path / "ckpt"))
    sd = _reference_sd(family, 4, cfg.data.num_classes)
    path = str(tmp_path / "current.pt")
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()}, "iteration": 1234, "ep_id": 7}, path)
    commands.import_torch_command(cfg, path, device="cpu")
    saved = torch.load(ckpt.ckpt_path(Paths(cfg).ckpt_dir()), weights_only=True)
    assert (saved["iteration"], saved["ep_id"], saved["optimizer"]["state"]) == (1234, 7, {})
    state = init_state(dataclasses.replace(cfg, seed=cfg.seed + 1), torch.device("cpu"))
    assert ckpt.restore_checkpoint(Paths(cfg).ckpt_dir(), state) == 7 and state.step == 1234
    want = FAMILIES[family][1](sd)
    assert all(torch.equal(v, want[k]) for k, v in state.model.state_dict().items())
    model = commands._load_eval_variables(cfg, "cpu")
    assert not model.training and all(torch.equal(v, want[k]) for k, v in model.state_dict().items())


JAX_TYPES = {t.__name__: t for t in (jkm.UNetPlan, jkm.LevelPlan, jkm.DownPlan, jdv.PointPlan, jdv.TriMap, jdv.AvgMap)}


def _to_jax(x):
    """The port's batch tuples as the JAX package's, field for field."""
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    if hasattr(x, "_fields"):
        return JAX_TYPES[type(x).__name__](*map(_to_jax, x))
    if isinstance(x, tuple):
        return tuple(map(_to_jax, x))
    return x


@pytest.mark.parametrize("family", ["Mink", "SPVCNN"])
def test_narrow_logits_through_a_current_pt_match_jax(tmp_path, family):
    _, _, export, _, _, cls = FAMILIES[family]
    spvcnn = family == "SPVCNN"
    torch.manual_seed(5)
    source = cls(num_classes=16, cs=NARROW).eval()
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():  # random BN, so the eval epilogues do real work
        for m in source.modules():
            if isinstance(m, MaskedBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    path = str(tmp_path / "current.pt")
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in export(source.state_dict()).items()},
                "iteration": 10, "ep_id": 2}, path)

    xyz, sig, valid, _ = surface_frames(84, b=2, p=512, n=480)
    eb = prepare_eval_batch(None, *torch_args(xyz, sig, valid), level_caps=(512, 512, 256, 128, 32), augment=False,
                            with_points=spvcnn)
    sd, iteration, ep_id = import_torch.load_torch_checkpoint(path)
    assert (iteration, ep_id) == (10, 2)
    model = cls(num_classes=16, cs=NARROW)
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        logits = forward_batch(model.eval(), eb)[0]
        logits_src = forward_batch(source, eb)[0]
    assert torch.equal(logits, logits_src)

    variables, j_iteration, _ = jimport.load_torch_checkpoint(path)
    assert j_iteration == 10
    if spvcnn:
        jmodel = JaxSPVCNN(num_classes=16, cs=NARROW, dropout_rate=0.0)
        args = (_to_jax(eb.feats), _to_jax(eb.plan), _to_jax(eb.pplan))
    else:
        jmodel = JaxMinkUNet(num_classes=16, cs=NARROW)
        args = (_to_jax(eb.feats), _to_jax(eb.plan))
    logits_j, _ = jax.jit(jmodel.apply, static_argnames="train")(variables, *args, train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=1e-4, atol=1e-4)
    valid0 = eb.plan.levels[0].valid.numpy()
    assert valid0.any() and np.abs(np.asarray(logits_j)[valid0]).max() > 0.1
