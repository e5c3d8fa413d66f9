"""Gather-GEMM sparse conv kernel (``csrc/subm_conv.cu``) and its plain version.

Replaces ``lidal_tpu/ops/pallas_conv.py:subm_conv_pallas``.  A CUDA tensor
launches the kernel; a CPU tensor takes :func:`subm_conv_plain`, the im2col
gather + matmul of ``lidal_tpu/ops/conv.py:33-43, 247-252`` that the kernel is
tested against.  An optional row order (``kernel_map.row_order``) makes
the kernel's row tiles walk the output rows in that order: a tile then
multiplies only the taps real in one of its rows, and each row's sums are
the same as without it (the plain version ignores it).
"""

from __future__ import annotations

import ctypes

import torch

from lidal_tpu_torch import kernels_build
from lidal_tpu_torch.utils import profiling

# Elements of im2col rows the plain version materialises at once: a level-0
# conv with cin = 128 would otherwise need ~7 GB at B = 4.
_PLAIN_CHUNK = 1 << 26


def _check(feats, w, nbr, scale, shift) -> None:
    if feats.dim() != 2 or w.dim() != 3 or nbr.dim() != 2:
        raise ValueError(
            f"feats [n, cin], w [K, cin, cout], nbr [m, K] expected, got "
            f"{tuple(feats.shape)}, {tuple(w.shape)}, {tuple(nbr.shape)}"
        )
    if w.shape[0] != nbr.shape[1] or w.shape[1] != feats.shape[1]:
        raise ValueError(f"w {tuple(w.shape)} does not fit feats {tuple(feats.shape)} and nbr {tuple(nbr.shape)}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if scale is not None and (scale.shape != (w.shape[2],) or shift.shape != (w.shape[2],)):
        raise ValueError(f"scale/shift must be [{w.shape[2]}]")


def subm_conv_plain(feats, w, nbr, scale=None, shift=None, relu: bool = False, *, order=None) -> torch.Tensor:
    """Plain torch version of :func:`subm_conv` (same arguments; ``order``
    changes no result and is not read)."""
    _check(feats, w, nbr, scale, shift)
    n, cin = feats.shape
    m, k = nbr.shape
    cout = w.shape[2]
    fx = torch.cat([feats, feats.new_zeros((1, cin))])
    idx = torch.where((nbr >= 0) & (nbr < n), nbr, n).long()
    wf = w.reshape(k * cin, cout)
    out = feats.new_empty((m, cout))
    rows = max(1, _PLAIN_CHUNK // (k * cin))
    for i0 in range(0, m, rows):
        out[i0 : i0 + rows] = fx[idx[i0 : i0 + rows]].reshape(-1, k * cin) @ wf
    if scale is None:
        return out
    y = out * scale + shift
    if relu:
        y = torch.clamp_min(y, 0.0)
    row_ok = (idx.min(dim=1).values < n).to(y.dtype)
    return y * row_ok[:, None]


def subm_conv(feats, w, nbr, scale=None, shift=None, relu: bool = False, *, order=None) -> torch.Tensor:
    """out[i] = sum_k feats[nbr[i, k]] @ w[k], f32; an index >= n gives 0.

    With ``scale``/``shift`` ([cout]) the eval-BN epilogue follows:
    ``y = out * scale + shift``, ``relu`` if asked, then 0 on rows whose taps
    are all sentinel.

    Args:
      feats: f32 [n, cin], cin % 4 == 0.
      w: f32 [K, cin, cout], K <= 27, cout % 32 == 0.
      nbr: int32 [m, K] source rows (sentinel n).
      order: int32 [m], a permutation of the rows (``kernel_map.row_order``):
        the kernel's row tiles take the rows in this order.  None: in row
        order.  It changes which rows share a tile, not a row's sums; with
        cin % 32 == 0 the output is bit-equal to the one without it.  The
        kernel relies on the permutation and does not check it: a row named
        twice is written by two blocks, a row never named is left as
        ``torch.empty`` gave it, and neither raises.
    """
    if feats.device.type == "cpu":
        return subm_conv_plain(feats, w, nbr, scale, shift, relu)
    if feats.device.type != "cuda":
        raise ValueError(f"subm_conv runs on CPU or CUDA tensors, got {feats.device}")
    _check(feats, w, nbr, scale, shift)
    n, cin = feats.shape
    m, k = nbr.shape
    cout = w.shape[2]
    if k > 27 or cin % 4 or cout % 32:
        raise ValueError(f"subm_conv kernel needs K <= 27, cin % 4 == 0, cout % 32 == 0; got {k}, {cin}, {cout}")
    args = [("feats", feats, torch.float32), ("w", w, torch.float32), ("nbr", nbr, torch.int32)]
    if scale is not None:
        args += [("scale", scale, torch.float32), ("shift", shift, torch.float32)]
    if order is not None:
        args.append(("order", order, torch.int32))
        if order.shape != (m,):
            raise ValueError(f"order must be [{m}], got {tuple(order.shape)}")
    for name, x, dtype in args:
        if x.device != feats.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {feats.device}")
    if feats.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("feats and w must be 16-byte aligned (float4 loads)")
    out = torch.empty((m, cout), dtype=torch.float32, device=feats.device)
    if m == 0:
        return out
    epilogue = 0 if scale is None else (2 if relu else 1)
    fn = kernels_build.function(
        "subm_conv", "lidal_subm_conv", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    with torch.cuda.device(feats.device):
        err = fn(
            feats.data_ptr(), w.data_ptr(), nbr.data_ptr(),
            order.data_ptr() if order is not None else None,
            scale.data_ptr() if scale is not None else None,
            shift.data_ptr() if shift is not None else None,
            out.data_ptr(), m, n, k, cin, cout, epilogue,
            torch.cuda.current_stream().cuda_stream,
        )
    profiling.count("launch.subm_conv")
    if order is not None:
        profiling.count("conv.row_order")
    kernels_build.check(err, "subm_conv")
    return out
