"""Sparse 3D convolution with fused eval BatchNorm (port of the inference half
of ``lidal_tpu/ops/conv.py``).

Every conv is "for each output voxel, which input voxel feeds tap k", so the
forward is one gather-GEMM (``ops/cuda_conv.py``) and never scatters.  Frames
flatten into one call: frame b's rows are offset by ``b * cap`` and each
frame's sentinel (its cap) maps to the global sentinel ``B * cap``.

Weight layout: ``[K, cin, cout]`` with tap order ``kernel_map.OFFSETS3`` /
``OFFSETS2`` (x-major), as in the JAX package.  The gradients (custom VJPs
there) are not ported yet.
"""

from __future__ import annotations

import torch

from lidal_tpu_torch.ops import cuda_conv


def _flatten_nbr(nbr: torch.Tensor, cap_src: int) -> torch.Tensor:
    b, m, k = nbr.shape
    off = (torch.arange(b, dtype=torch.int32, device=nbr.device) * cap_src)[:, None, None]
    return torch.where(nbr < cap_src, nbr + off, b * cap_src).to(torch.int32).reshape(b * m, k)


def _flatten_idx(idx: torch.Tensor, cap_src: int) -> torch.Tensor:
    b, m = idx.shape
    off = (torch.arange(b, dtype=torch.int32, device=idx.device) * cap_src)[:, None]
    return torch.where(idx < cap_src, idx + off, b * cap_src).to(torch.int32).reshape(b * m)


def _up_nbr(parent: torch.Tensor, pdelta: torch.Tensor, k: int, cap_coarse: int) -> torch.Tensor:
    """Expand (parent, pdelta) into a per-tap column map [cap_fine, K]:
    column d holds parent[f] where pdelta[f] == d, else the sentinel."""
    taps = torch.arange(k, dtype=torch.int32, device=parent.device)[None, :]
    ok = (pdelta[:, None] == taps) & (parent[:, None] < cap_coarse)
    return torch.where(ok, parent[:, None], cap_coarse).to(torch.int32)


def _conv_bn_eval(feats, w, nbr, scale, shift, relu: bool) -> torch.Tensor:
    """relu?((gather-GEMM) * scale + shift), zeroed on rows with no real tap."""
    return cuda_conv.subm_conv(feats, w, nbr, scale, shift, relu)


def subm_conv_bn_batched(x, w, nbr, scale, shift, relu: bool = False) -> torch.Tensor:
    """x [B, cap, cin], nbr [B, cap, 27] -> [B, cap, cout]."""
    b, n, c = x.shape
    out = _conv_bn_eval(x.reshape(b * n, c), w, _flatten_nbr(nbr, n), scale, shift, relu)
    return out.reshape(b, n, -1)


def down_conv_bn_batched(x, w, child, scale, shift, relu: bool = False) -> torch.Tensor:
    """x [B, cap_fine, cin], child [B, cap_coarse, 8] -> [B, cap_coarse, cout]."""
    b, nf, c = x.shape
    nc = child.shape[1]
    out = _conv_bn_eval(x.reshape(b * nf, c), w, _flatten_nbr(child, nf), scale, shift, relu)
    return out.reshape(b, nc, -1)


def up_conv_bn_batched(x, w, parent, pdelta, scale, shift, relu: bool = False) -> torch.Tensor:
    """x [B, cap_coarse, cin], parent/pdelta [B, cap_fine] -> [B, cap_fine, cout]."""
    b, nc, c = x.shape
    nf = parent.shape[1]
    nbr_up = _up_nbr(_flatten_idx(parent, nc), pdelta.reshape(b * nf), w.shape[0], b * nc)
    out = _conv_bn_eval(x.reshape(b * nc, c), w, nbr_up, scale, shift, relu)
    return out.reshape(b, nf, -1)
