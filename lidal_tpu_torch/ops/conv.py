"""Sparse 3D convolution (port of ``lidal_tpu/ops/conv.py``): the three
differentiable convs for training and the fused conv + eval-BN entries for
inference.

Every conv is "for each output voxel, which input voxel feeds tap k", so the
forward is one gather-GEMM (``ops/cuda_conv.py``) and never scatters.  The
backward uses the mirrored or paired map, again a pure gather: one
``ops/cuda_conv_dxdw.conv_dx_dw`` call gives the input gradient and ``dwg``,
from which each conv recovers dW (the JAX custom VJPs, ``conv.py:102-223``):

* subm: ``dX = conv(dY, flip(W)^T)`` over ``nbr`` and ``dW = flip(dwg)``, by
  the mirror identity ``nbr[i, k] == j  <=>  nbr[j, K-1-k] == i``;
* down: ``dX`` and ``dW = dwg`` over the up map built from ``(parent, pdelta)``,
  since ``child[o, d] == f  <=>  nbr_up[f, d] == o``;
* up: ``dX`` and ``dW = dwg`` over ``child``, the same pairing seen from the
  coarse side.

Frames flatten into one call: frame b's rows are offset by ``b * cap`` and
each frame's sentinel (its cap) maps to the global sentinel ``B * cap``.

Weight layout: ``[K, cin, cout]`` with tap order ``kernel_map.OFFSETS3`` /
``OFFSETS2`` (x-major), as in the JAX package.  The kernel wrappers are
called through their modules, so a caller can swap in the plain versions.
"""

from __future__ import annotations

import torch

from lidal_tpu_torch.ops import cuda_conv, cuda_conv_dxdw


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


class _GatherConv(torch.autograd.Function):
    """``out[i] = sum_k feats[fwd[i, k]] @ w[k]``; the backward runs
    ``conv_dx_dw`` over ``bwd`` with ``w2 = w^T`` (flipped when ``mirror``)
    and takes ``dW = dwg`` (flipped back when ``mirror``)."""

    @staticmethod
    def forward(ctx, feats, w, fwd, bwd, mirror: bool):
        ctx.save_for_backward(feats, w, bwd)
        ctx.mirror = mirror
        return cuda_conv.subm_conv(feats, w, fwd)

    @staticmethod
    def backward(ctx, dy):
        feats, w, bwd = ctx.saved_tensors
        w2 = (w.flip(0) if ctx.mirror else w).transpose(1, 2).contiguous()
        dx, dwg = cuda_conv_dxdw.conv_dx_dw(dy.contiguous(), w2, bwd, feats, ctx.needs_input_grad[0])
        return dx, (dwg.flip(0) if ctx.mirror else dwg), None, None, None


def subm_conv(feats: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k feats[nbr[i, k]] @ w[k]; feats [cap, cin], w [K, cin, cout],
    nbr [cap, K] (sentinel cap), K odd with mirrored taps."""
    return _GatherConv.apply(feats, w, nbr, nbr, True)


def down_conv(feats, w, child, parent, pdelta) -> torch.Tensor:
    """out[o] = sum_d feats[child[o, d]] @ w[d]; feats [cap_fine, cin],
    child [cap_coarse, 8], parent/pdelta [cap_fine] (for the backward)."""
    nbr_up = _up_nbr(parent, pdelta, w.shape[0], child.shape[0])
    return _GatherConv.apply(feats, w, child, nbr_up, False)


def up_conv(feats, w, child, parent, pdelta) -> torch.Tensor:
    """out[f] = feats[parent[f]] @ w[pdelta[f]]; feats [cap_coarse, cin],
    parent/pdelta [cap_fine], child [cap_coarse, 8] (for the backward)."""
    nbr_up = _up_nbr(parent, pdelta, w.shape[0], feats.shape[0])
    return _GatherConv.apply(feats, w, nbr_up, child, False)


def subm_conv_batched(x, w, nbr) -> torch.Tensor:
    """x [B, cap, cin], nbr [B, cap, K] -> [B, cap, cout]."""
    b, n, c = x.shape
    return subm_conv(x.reshape(b * n, c), w, _flatten_nbr(nbr, n)).reshape(b, n, -1)


def down_conv_batched(x, w, child, parent, pdelta) -> torch.Tensor:
    """x [B, cap_fine, cin], child [B, cap_coarse, 8], parent/pdelta [B, cap_fine]."""
    b, nf, c = x.shape
    nc = child.shape[1]
    out = down_conv(
        x.reshape(b * nf, c), w, _flatten_nbr(child, nf), _flatten_idx(parent, nc), pdelta.reshape(b * nf)
    )
    return out.reshape(b, nc, -1)


def up_conv_batched(x, w, child, parent, pdelta) -> torch.Tensor:
    """x [B, cap_coarse, cin], child [B, cap_coarse, 8], parent/pdelta [B, cap_fine]."""
    b, nc, c = x.shape
    nf = parent.shape[1]
    out = up_conv(
        x.reshape(b * nc, c), w, _flatten_nbr(child, nf), _flatten_idx(parent, nc), pdelta.reshape(b * nf)
    )
    return out.reshape(b, nf, -1)


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
