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

A map wider than the kernels' 27 taps (PTv3's kernel-5 stem, 125 taps)
runs as groups of at most 27 of its columns (:func:`subm_conv_wide`): the
forward adds the groups' gather-GEMMs, the backward adds their dx and
concatenates their dwg, so every launch is one of the 27-tap kernels.

Frames flatten into one call: frame b's rows are offset by ``b * cap`` and
each frame's sentinel (its cap) maps to the global sentinel ``B * cap``.

Weight layout: ``[K, cin, cout]`` with tap order ``kernel_map.OFFSETS3`` /
``OFFSETS2`` (x-major), as in the JAX package.  The kernel wrappers are
called through their modules, so a caller can swap in the plain versions.

:data:`BF16_OPERANDS` picks the route.  Off (the default, on every device)
every conv runs the f32 kernels above.  On, it is the route the JAX package
takes on its TPU (``lidal_tpu/ops/conv.py:51`` ``USE_PALLAS``): operands
staged in bf16, sums and the epilogue in f32, on the bf16 kernels, forward
``cuda_conv_bf16.conv_gather_first`` (with the eval-BN epilogue in
inference) and backward ``cuda_conv_dxdw_fused.conv_dx_dw_fused`` (dW alone
where the input needs no gradient); SPVCNN's ``gather8`` then reads a bf16
table (``ops/devoxelize.py``).  Activations between layers stay f32.  A
shape that a bf16 kernel does not take raises: the route never falls back
to the f32 kernels.  :func:`bf16_route` is how the package's own code (the
command line's ``--bf16_route``) turns the route on: it sets this switch and
restores it.  It is the route's one switch, forward and backward, also for
SPVCNN's point transfers: the kernel wrappers read no switch, the route is
passed down to them as an argument.
"""

from __future__ import annotations

import contextlib

import torch

from lidal_tpu_torch.ops import cuda_conv, cuda_conv_bf16, cuda_conv_dxdw, cuda_conv_dxdw_fused

# The bf16 route (operands rounded to bf16, f32 sums): the counterpart of
# lidal_tpu/ops/conv.py:USE_PALLAS and pallas_gather8.USE_PALLAS_BWD set
# together.  A forward takes the route it finds here, and its backward the same.
BF16_OPERANDS: bool = False


@contextlib.contextmanager
def bf16_route(on: bool = True):
    """Within: the bf16 route on (or off, with ``on=False``) for every conv and
    for SPVCNN's point transfers and their backward: :data:`BF16_OPERANDS`
    set to ``on``.  On exit, also after an exception, it gets back the value
    it had before, so the context nests."""
    global BF16_OPERANDS
    before = BF16_OPERANDS
    BF16_OPERANDS = bool(on)
    try:
        yield
    finally:
        BF16_OPERANDS = before


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
    and takes ``dW = dwg`` (flipped back when ``mirror``).  Under
    :data:`BF16_OPERANDS` the two are ``conv_gather_first`` and
    ``conv_dx_dw_fused``."""

    @staticmethod
    def forward(ctx, feats, w, fwd, bwd, mirror: bool):
        ctx.save_for_backward(feats, w, bwd)
        ctx.mirror = mirror
        ctx.bf16 = BF16_OPERANDS
        if ctx.bf16:
            return cuda_conv_bf16.conv_gather_first(feats, w, fwd)
        return cuda_conv.subm_conv(feats, w, fwd)

    @staticmethod
    def backward(ctx, dy):
        feats, w, bwd = ctx.saved_tensors
        w2 = (w.flip(0) if ctx.mirror else w).transpose(1, 2).contiguous()
        need_dx = ctx.needs_input_grad[0]
        if ctx.bf16:
            dx, dwg = cuda_conv_dxdw_fused.conv_dx_dw_fused(dy.contiguous(), w2, bwd, feats, "dx_dw", need_dx)
        else:
            dx, dwg = cuda_conv_dxdw.conv_dx_dw(dy.contiguous(), w2, bwd, feats, need_dx)
        return dx, (dwg.flip(0) if ctx.mirror else dwg), None, None, None


KERNEL_TAPS = 27  # the most taps one launch of the f32 kernels takes


def _tap_groups(k: int):
    return [slice(g, min(g + KERNEL_TAPS, k)) for g in range(0, k, KERNEL_TAPS)]


class _WideSubmConv(torch.autograd.Function):
    """:class:`_GatherConv` over a mirrored map of more than
    :data:`KERNEL_TAPS` taps, one f32 launch per group of columns: the
    forward adds the groups' outputs; the backward runs ``conv_dx_dw`` over
    each group with ``w2 = flip(w)^T``, adds the dx and concatenates the dwg
    (flipped back).  The bf16 route has no such shape: it raises."""

    @staticmethod
    def forward(ctx, feats, w, nbr):
        if BF16_OPERANDS:
            raise ValueError(f"no bf16 route for a {w.shape[0]}-tap conv")
        ctx.save_for_backward(feats, w, nbr)
        out = None
        for g in _tap_groups(w.shape[0]):
            part = cuda_conv.subm_conv(feats, w[g].contiguous(), nbr[:, g].contiguous())
            out = part if out is None else out + part
        return out

    @staticmethod
    def backward(ctx, dy):
        feats, w, nbr = ctx.saved_tensors
        w2 = w.flip(0).transpose(1, 2).contiguous()
        need_dx = ctx.needs_input_grad[0]
        dy = dy.contiguous()
        dx, dwgs = None, []
        for g in _tap_groups(w.shape[0]):
            dx_g, dwg = cuda_conv_dxdw.conv_dx_dw(dy, w2[g].contiguous(), nbr[:, g].contiguous(), feats, need_dx)
            dx = dx_g if dx is None else dx + dx_g
            dwgs.append(dwg)
        return dx, torch.cat(dwgs).flip(0), None


def subm_conv_wide(feats: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """:func:`subm_conv` for K > :data:`KERNEL_TAPS` (odd, mirrored taps)."""
    return _WideSubmConv.apply(feats, w, nbr)


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
    """x [B, cap, cin], nbr [B, cap, K] -> [B, cap, cout] (K > 27 in groups of taps)."""
    b, n, c = x.shape
    conv = subm_conv_wide if w.shape[0] > KERNEL_TAPS else subm_conv
    return conv(x.reshape(b * n, c), w, _flatten_nbr(nbr, n)).reshape(b, n, -1)


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
    if BF16_OPERANDS:
        return cuda_conv_bf16.conv_gather_first(feats, w, nbr, scale=scale, shift=shift, relu=relu)
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
