"""Band-pairwise nearest-neighbour kernel (``csrc/nn_band.cu``) and its plain
version.

Replaces ``lidal_tpu/ops/pallas_nnband.py:nn_band_pallas``.  A CUDA tensor
launches the kernel; a CPU tensor takes :func:`nn_band_plain`, which has the
semantics of ``nn_band_xla`` there: full pairwise f32
``(dx*dx + dy*dy) + dz*dz`` over the block-rounded band of each (slot, query
tile), the minimum, and the lowest row among ties; ``(inf, 0)`` for an empty
band.  The kernel is bit-equal to the plain version, ``d2`` and ``row``: it
skips a group of ``GROUP`` cell-sorted rows only where a lower bound that is
exact under rounding exceeds every query's best so far (``csrc/nn_band.cu``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lidal_tpu_torch import kernels_build
from lidal_tpu_torch.utils import profiling

TILE = 256  # queries per band (one query tile)
TN = 1024  # table rows per band block
GROUP = 32  # rows per box of the kernel's pruned scan (kGroup of csrc/nn_band.cu)
WINDOW = 2048  # rows the kernel stages in shared memory at once (kWindow)
BIG_COORD = 1.0e9  # padding coordinate of invalid table rows (``build_grid``)

# Elements of one [slots, TILE, band rows] distance block of the plain version.
_PLAIN_CHUNK = 1 << 26
_BIG_ROW = 2**30


def _check(tbl, q_t, blo, nb) -> Tuple[int, int, int, int]:
    if tbl.dim() != 3 or tbl.shape[1] != 3 or q_t.dim() != 2 or q_t.shape[0] != 3:
        raise ValueError(f"tbl [S, 3, cap] and q_t [3, p] expected, got {tuple(tbl.shape)}, {tuple(q_t.shape)}")
    s, _, cap = tbl.shape
    p = q_t.shape[1]
    if p % TILE or cap % TN:
        raise ValueError(f"nn_band needs p % {TILE} == 0 and cap % {TN} == 0; got p = {p}, cap = {cap}")
    tiles = p // TILE
    if blo.shape != (s, tiles) or nb.shape != (s, tiles):
        raise ValueError(f"blo and nb must be [{s}, {tiles}], got {tuple(blo.shape)}, {tuple(nb.shape)}")
    return s, cap, p, tiles


def nn_band_plain(tbl, q_t, blo, nb) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`nn_band` (same arguments).  Every product
    and sum is an op of its own, so nothing is contracted into an FMA."""
    s, cap, p, tiles = _check(tbl, q_t, blo, nb)
    dev = tbl.device
    d2_out = torch.full((s, p), float("inf"), dtype=torch.float32, device=dev)
    row_out = torch.zeros((s, p), dtype=torch.int32, device=dev)
    if s == 0 or p == 0 or cap == 0:
        return d2_out, row_out
    widest = nb.max(dim=0).values.tolist()  # band blocks of the widest slot, per tile
    ar = torch.arange(max(widest) * TN, dtype=torch.int32, device=dev)
    for t, blocks in enumerate(widest):
        if blocks == 0:
            continue
        length = blocks * TN
        q = q_t[:, t * TILE : (t + 1) * TILE]  # [3, TILE]
        per = max(1, _PLAIN_CHUNK // (TILE * length))
        for s0 in range(0, s, per):
            sl = slice(s0, s0 + per)
            rows = blo[sl, t, None] * TN + ar[None, :length]  # [s', length] int32
            in_band = ar[None, :length] < nb[sl, t, None] * TN
            idx = rows.clamp_max(cap - 1).long()[:, None, :].expand(-1, 3, -1)
            win = tbl[sl].gather(2, idx)  # [s', 3, length]
            dx = win[:, 0, None, :] - q[0][None, :, None]  # [s', TILE, length]
            dy = win[:, 1, None, :] - q[1][None, :, None]
            dz = win[:, 2, None, :] - q[2][None, :, None]
            d2 = (dx * dx + dy * dy) + dz * dz
            d2 = torch.where(in_band[:, None, :], d2, float("inf"))
            best = d2.amin(dim=2)  # [s', TILE]
            cand = torch.where(d2 == best[..., None], rows[:, None, :], _BIG_ROW).amin(dim=2)
            d2_out[sl, t * TILE : (t + 1) * TILE] = best
            row_out[sl, t * TILE : (t + 1) * TILE] = torch.where(best == float("inf"), 0, cand)
    return d2_out, row_out


def nn_band(tbl, q_t, blo, nb) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (neighbour slot, query): min squared distance over the query tile's
    band, and the lowest table row that attains it.

    Args:
      tbl: f32 [S, 3, cap] planar table coords in cell order (``BIG_COORD``
        pad), ``cap % TN == 0``.
      q_t: f32 [3, p] cell-sorted query coords, ``p % TILE == 0``.
      blo: int32 [S, p // TILE] first band block per (slot, tile).
      nb: int32 [S, p // TILE] band block count.

    Returns: (d2 f32 [S, p], inf where the band is empty; row int32 [S, p]).
    """
    if tbl.device.type == "cpu":
        return nn_band_plain(tbl, q_t, blo, nb)
    d2, row, _, _ = _launch(tbl, q_t, blo, nb, counted=False)
    return d2, row


def nn_band_counted(tbl, q_t, blo, nb) -> Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor]:
    """:func:`nn_band` on a card with the kernel's statistics: ``(d2, row,
    pairs, needed)``, where ``pairs`` is the number of (query, row) pairs the
    kernel evaluated (its warps scan a group of ``GROUP`` rows for all 32
    queries or skip it) and ``needed`` int32 [S, p] the groups each query's
    own lower bound could not exclude.  Reads the counter back (a sync): for
    checks and measurements, not for the main path."""
    d2, row, pairs, needed = _launch(tbl, q_t, blo, nb, counted=True)
    return d2, row, int(pairs.item()), needed


def _launch(tbl, q_t, blo, nb, counted: bool):
    if tbl.device.type != "cuda":
        raise ValueError(f"the nn_band kernel runs on CUDA tensors, got {tbl.device}")
    s, cap, p, tiles = _check(tbl, q_t, blo, nb)
    if s > 65535:
        raise ValueError(f"nn_band takes at most 65535 slots, got {s}")
    for name, x, dtype in (("tbl", tbl, torch.float32), ("q_t", q_t, torch.float32),
                           ("blo", blo, torch.int32), ("nb", nb, torch.int32)):
        if x.device != tbl.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {tbl.device}")
    if tbl.data_ptr() % 16:
        raise ValueError("tbl must be 16-byte aligned (float4 loads)")
    d2 = torch.empty((s, p), dtype=torch.float32, device=tbl.device)
    row = torch.empty((s, p), dtype=torch.int32, device=tbl.device)
    pairs = needed = None
    if counted:
        pairs = torch.zeros((), dtype=torch.int64, device=tbl.device)
        needed = torch.empty((s, p), dtype=torch.int32, device=tbl.device)
    if s * p == 0:
        return d2, row, pairs, needed
    fn = kernels_build.function(
        "nn_band", "lidal_nn_band", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    )
    with torch.cuda.device(tbl.device):
        err = fn(
            tbl.data_ptr(), q_t.data_ptr(), blo.data_ptr(), nb.data_ptr(), d2.data_ptr(), row.data_ptr(),
            s, cap, p, None if pairs is None else pairs.data_ptr(), None if needed is None else needed.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    profiling.count("launch.nn_band")
    kernels_build.check(err, "nn_band")
    return d2, row, pairs, needed
