"""Carry JAX MinkUNet variables into the port's ``MinkUNet``.

:func:`minkunet_state_dict_from_jax` maps the flax ``{"params",
"batch_stats"}`` tree of ``lidal_tpu.models.MinkUNet`` (numpy leaves) onto
the port's state-dict names, which are the reference torchsparse names
(``network/minkunet.py:22-89``).  Conv kernels keep the JAX layout ``[K, cin,
cout]`` with x-major taps, so a torchsparse checkpoint loads through the same
map: ``minkunet_state_dict_from_jax(convert_minkunet_state_dict(sd))``
(``lidal_tpu/runtime/import_torch.py``, which imports numpy only).  The flax
module names follow ``import_torch.py:203-249``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def minkunet_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def put(name, value):
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32))

    def conv(t_name, p, sub):
        put(f"{t_name}.kernel", p[sub]["w"])

    def bn(t_name, p, s):
        put(f"{t_name}.weight", p["scale"])
        put(f"{t_name}.bias", p["bias"])
        put(f"{t_name}.running_mean", s["mean"])
        put(f"{t_name}.running_var", s["var"])

    def residual(t, name):
        p, s = params[name], stats[name]
        conv(f"{t}.net.0", p, "SubMConv3_0")
        bn(f"{t}.net.1", p["MaskedBatchNorm_0"], s["MaskedBatchNorm_0"])
        conv(f"{t}.net.3", p, "SubMConv3_1")
        bn(f"{t}.net.4", p["MaskedBatchNorm_1"], s["MaskedBatchNorm_1"])
        if "Conv1x1_0" in p:
            conv(f"{t}.downsample.0", p, "Conv1x1_0")
            bn(f"{t}.downsample.1", p["MaskedBatchNorm_2"], s["MaskedBatchNorm_2"])

    for i, (c, b) in enumerate((("stem.0", "stem.1"), ("stem.3", "stem.4"))):
        name = f"ConvBlock_{i}"
        conv(c, params[name], "SubMConv3_0")
        bn(b, params[name]["MaskedBatchNorm_0"], stats[name]["MaskedBatchNorm_0"])
    for i in range(4):
        t, name = f"stage{i + 1}", f"DownBlock_{i}"
        conv(f"{t}.0.net.0", params[name], "DownConv2_0")
        bn(f"{t}.0.net.1", params[name]["MaskedBatchNorm_0"], stats[name]["MaskedBatchNorm_0"])
        residual(f"{t}.1", f"ResidualBlock_{2 * i}")
        residual(f"{t}.2", f"ResidualBlock_{2 * i + 1}")
    for j in range(4):
        t, name = f"up{j + 1}", f"UpBlock_{j}"
        conv(f"{t}.0.net.0", params[name], "UpConv2_0")
        bn(f"{t}.0.net.1", params[name]["MaskedBatchNorm_0"], stats[name]["MaskedBatchNorm_0"])
        residual(f"{t}.1.0", f"ResidualBlock_{8 + 2 * j}")
        residual(f"{t}.1.1", f"ResidualBlock_{8 + 2 * j + 1}")
    put("classifier.0.weight", np.asarray(params["TorchLinear_0"]["w"]).T)
    put("classifier.0.bias", params["TorchLinear_0"]["b"])
    return sd
