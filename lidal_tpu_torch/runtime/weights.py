"""Carry JAX MinkUNet / SPVCNN variables and Adam state into the port.

:func:`minkunet_state_dict_from_jax` maps the flax ``{"params",
"batch_stats"}`` tree of ``lidal_tpu.models.MinkUNet`` (numpy leaves) onto
the port's state-dict names, which are the reference torchsparse names
(``network/minkunet.py:22-89``).  Conv kernels keep the JAX layout ``[K, cin,
cout]`` with x-major taps, so a torchsparse checkpoint loads through the same
map: ``minkunet_state_dict_from_jax(convert_minkunet_state_dict(sd))``
(``lidal_tpu/runtime/import_torch.py``, which imports numpy only).  The flax
module names follow ``import_torch.py:203-249``.
:func:`spvcnn_state_dict_from_jax` does the same for ``lidal_tpu.models.SPVCNN``:
the trunk plus ``PointTransform_{i}`` -> ``point_transforms.{i}`` (the Linear
weight transposed to torch's ``[out, in]``, ``import_torch.py:184-200``).

:func:`adam_state_from_jax` maps optax Adam's ``ScaleByAdamState(count, mu,
nu)`` through the same names onto ``torch.optim.Adam``'s per-parameter
``step``, ``exp_avg`` and ``exp_avg_sq``, so a run can continue from a JAX
training state with its moments and bias correction.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from lidal_tpu_torch.runtime.train import make_optimizer


def _walk_variables(params, stats: Optional[dict], put) -> None:
    """Call ``put(torch_name, value)`` for every parameter of the flax tree
    (and every BN statistic when ``stats`` is given)."""

    def conv(t_name, p, sub):
        put(f"{t_name}.kernel", p[sub]["w"])

    def bn(t_name, p, s):
        put(f"{t_name}.weight", p["scale"])
        put(f"{t_name}.bias", p["bias"])
        if s is not None:
            put(f"{t_name}.running_mean", s["mean"])
            put(f"{t_name}.running_var", s["var"])

    def sub(tree, name):
        return None if tree is None else tree[name]

    def residual(t, name):
        p, s = params[name], sub(stats, name)
        conv(f"{t}.net.0", p, "SubMConv3_0")
        bn(f"{t}.net.1", p["MaskedBatchNorm_0"], sub(s, "MaskedBatchNorm_0"))
        conv(f"{t}.net.3", p, "SubMConv3_1")
        bn(f"{t}.net.4", p["MaskedBatchNorm_1"], sub(s, "MaskedBatchNorm_1"))
        if "Conv1x1_0" in p:
            conv(f"{t}.downsample.0", p, "Conv1x1_0")
            bn(f"{t}.downsample.1", p["MaskedBatchNorm_2"], sub(s, "MaskedBatchNorm_2"))

    def block(t, name, conv_name):
        conv(f"{t}.net.0", params[name], conv_name)
        bn(f"{t}.net.1", params[name]["MaskedBatchNorm_0"], sub(sub(stats, name), "MaskedBatchNorm_0"))

    for i, (c, b) in enumerate((("stem.0", "stem.1"), ("stem.3", "stem.4"))):
        name = f"ConvBlock_{i}"
        conv(c, params[name], "SubMConv3_0")
        bn(b, params[name]["MaskedBatchNorm_0"], sub(sub(stats, name), "MaskedBatchNorm_0"))
    for i in range(4):
        block(f"stage{i + 1}.0", f"DownBlock_{i}", "DownConv2_0")
        residual(f"stage{i + 1}.1", f"ResidualBlock_{2 * i}")
        residual(f"stage{i + 1}.2", f"ResidualBlock_{2 * i + 1}")
    for j in range(4):
        block(f"up{j + 1}.0", f"UpBlock_{j}", "UpConv2_0")
        residual(f"up{j + 1}.1.0", f"ResidualBlock_{8 + 2 * j}")
        residual(f"up{j + 1}.1.1", f"ResidualBlock_{8 + 2 * j + 1}")
    put("classifier.0.weight", np.asarray(params["TorchLinear_0"]["w"]).T)
    put("classifier.0.bias", params["TorchLinear_0"]["b"])
    # SPVCNN's point branch; a MinkUNet tree has none of these
    for i in range(3):
        name = f"PointTransform_{i}"
        if name not in params:
            break
        put(f"point_transforms.{i}.0.weight", np.asarray(params[name]["TorchLinear_0"]["w"]).T)
        put(f"point_transforms.{i}.0.bias", params[name]["TorchLinear_0"]["b"])
        bn(f"point_transforms.{i}.1", params[name]["MaskedBatchNorm_0"], sub(sub(stats, name), "MaskedBatchNorm_0"))


def _to_torch(tree, stats=None) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def put(name, value):
        out[name] = torch.from_numpy(np.array(value, dtype=np.float32))

    _walk_variables(tree, stats, put)
    return out


def minkunet_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    return _to_torch(variables["params"], variables["batch_stats"])


def spvcnn_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    if "PointTransform_0" not in variables["params"]:
        raise ValueError("the variables hold no point transforms: not an SPVCNN tree")
    return _to_torch(variables["params"], variables["batch_stats"])


def adam_state_from_jax(opt_state, model: torch.nn.Module) -> dict:
    """An optimizer state dict for ``runtime/train.make_optimizer(model)``
    holding the JAX Adam state ``opt_state`` (``optax.adam``: a chain whose
    first element is ``ScaleByAdamState(count, mu, nu)``); load it with
    ``optimizer.load_state_dict``.  ``mu``/``nu`` take the parameter names of
    :func:`minkunet_state_dict_from_jax` or :func:`spvcnn_state_dict_from_jax`,
    whichever ``model`` is (Linear weights transposed)."""
    adam = opt_state[0]
    mu, nu = _to_torch(adam.mu), _to_torch(adam.nu)
    step = float(np.asarray(adam.count))
    sd = make_optimizer(model).state_dict()
    names = [name for name, _ in model.named_parameters()]
    if sorted(names) != sorted(mu):
        raise ValueError("the JAX Adam moments do not name the model's parameters")
    sd["state"] = {
        i: {"step": torch.tensor(step), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for i, name in enumerate(names)
    }
    return sd
