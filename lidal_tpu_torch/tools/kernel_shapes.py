"""Time the lookup and the conv kernel at the shapes of one B = 4 eval batch,
and the conv backward kernel at the shapes of one B = 5 train step.

    python3 lidal_tpu_torch/tools/kernel_shapes.py [ROOT] [--only SECTIONS]   # on an NVIDIA GPU

SECTIONS is a comma-separated subset of
``lookup,conv,backward,nn_band,scatter8,gather8,probes,digests`` (default: all).

ROOT (default: this checkout) goes first on ``sys.path`` before anything of the
port is imported, so the same script measures another checkout with the same
batch and the same timing: a parent commit unpacked with ``git archive``, or a
copy with one kernel constant changed.  The batch is ``make_batch`` of ROOT's
``chip_smoke.py`` (B = 4 synthetic SemanticKITTI-scale frames of 120k points,
seed 0).  It prints the card's name and power limit, then

* per level of the plan: the lookup kernel's ms against ``torch.searchsorted``
  on ready int64 keys (CUDA events), both checked bit-equal to the plain
  version, and, where ROOT's wrapper counts them, the tiles whose window was
  searched in device memory;
* per conv shape of the forward: the kernel's ms, its max |kernel - plain|, the
  GFLOP of the real (row, tap) pairs and of the dense work of the kernel's row
  tiles (every tap that is real somewhere in a tile, times the tile's rows;
  tiles of 64 rows at cout % 96 == 0 or cout % 128 == 0, else 128), and the
  TFLOP/s reached on that dense work; then the sums per forward;
* per ``conv_dx_dw`` shape of one train step (B = 5 frames of ``make_batch``,
  seed 0, the MinkUNet of ``init_state`` with seed 0): the kernel's ms with
  dx and dW apart (dW alone is the ``need_dx=False`` call on the same
  arguments, dx the rest), each checked within ``CONV_TOL`` of the plain
  version's abs-sum, the real (row, tap) pairs, the GFLOP of dW on them and
  the TFLOP/s reached; then the sums per step;
* ``nn_band`` at ``chip_smoke.py`` phase 11's shape (26 slots x 131072
  queries: the grids of 26 registered frames of ROOT's ``write_round_tree``,
  seed 6, in a temporary directory): the kernel's ms, checked bit-equal to the
  plain version, the pairs in the bands and, where ROOT's wrapper counts
  them, the pairs the kernel evaluated;
* ``scatter8`` at both shapes of one SPVCNN train step (B = 5, seed 0) and on
  the full maps of those shapes (``dense_map_inputs``): the kernel's ms,
  checked within ``SCATTER_TOL`` of the plain version's abs-sum, and the
  transposed map's ms (ROOT's ``transpose_map`` where it has one, else
  ``build_transpose``); where ROOT has ``transpose_map``, also its ms on maps
  whose every pair names one target (segments of 2^16, 2^18 and 2^20 ids);
* ``gather8``, the point transfers of SPVCNN on both routes (f32, and the
  bf16 route of ``ops/conv.BF16_OPERANDS``): the ms of each ``devoxelize_trilinear_batched``
  and ``point_to_voxel_avg_batched`` call of one B = 4 eval forward (seed 0)
  as the model makes it, and of each call of the ``gather8_forward`` /
  ``child_sum`` wrappers inside them (ROOT's ``child_sum`` where it has one);
  then both ``scatter8`` calls of one B = 5 train step (seed 0) on each route.
  Where ROOT's route wrappers cast their tables to bf16 (packages without
  ``child_sum``), the cast of each table is timed apart: the kernel is the
  wrapper less it.  Each route's sums per forward and per step.  Where ROOT's
  ``chip_smoke.py`` has phase 14's ``gather_work_phase``, that runs too on
  the same forward and model, on both routes (every call against its plain
  version, the library calls, the bounds, full maps and full trees), and
  last a ``zero_()`` of each trilinear call's output, the card's rate for
  writing those bytes;
* ``probes``, the three bf16 probe kernels: ``conv_gather_first`` (kernel
  alone on packed operands, both ``pipelined`` values, and the wrapper) at the
  six shapes of ``tools/probe_conv_v3`` and on the three real maps of
  ``chip_smoke.py`` phase 19 (one B = 4 forward, seed 0) beside the f32
  ``subm_conv`` on the same inputs; ``conv_byte_planes`` at the two shapes of
  ``tools/probe_int8_gather``; ``conv_dx_dw_fused`` (modes ``dx`` and
  ``dx_dw``) at the three shapes of ``tools/probe_dxdw_features`` and at every
  ``conv_dx_dw`` shape of one B = 5 train step (seed 0) beside the f32
  ``conv_dx_dw``.  Each checked within 1e-5 of the plain version's abs-sum;
  per shape the ms, the real pairs' GFLOP and TFLOP/s on them and, where
  ROOT's wrapper counts them (``cuda_conv_bf16.tile_products``), the products
  the gather-first tile issues, their TFLOP/s and the issue/real ratio; on the
  real maps also the issue/real ratio a tile would have that packed each
  tap's real rows of a window of 128, 384 or 1024 rows into 64-row groups;
  and the fused backward's device time by kernel over one step's calls.
  Last, a sha256 of the f32 ``conv_dx_dw``'s dx and dwg on seeded inputs (the
  probe's two step shapes, and a 4 %-dense K = 27 map), to hold two packages'
  outputs bit-equal by their printed digests;
* ``digests``: a sha256 of the outputs of every kernel that both the f32
  route and the bf16 probes had before the bf16 route (``subm_conv`` with and
  without its epilogue, ``conv_dx_dw``, ``gather8``, ``scatter8``,
  ``conv_gather_first`` without an epilogue, ``conv_dx_dw_fused`` in mode
  ``dx_dw``) on seeded inputs at the sizes of a B = 4 level-0 conv, of
  ``gather8`` and ``scatter8`` on the bf16 route, and of SPVCNN's point
  transfers on both routes (``devoxelize_trilinear_batched`` and
  ``point_to_voxel_avg_batched`` of a B = 4 plan, seed 0, forward and
  gradient), through the signatures both packages share: two packages print
  equal lines where their kernels give equal bits.
"""

from __future__ import annotations

import os
import subprocess
import sys


def _tile_rows(cout: int) -> int:
    """Rows of the conv kernel's tile at this cout (``Tile::BM`` of gather_gemm.cuh)."""
    return 64 if cout % 128 == 0 or cout % 96 == 0 else 128


SECTIONS = ("lookup", "conv", "backward", "nn_band", "scatter8", "gather8", "probes", "digests")


def main(root: str, only=SECTIONS) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: kernel_shapes times the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"package under {os.path.abspath(root)}")
    dev = torch.device("cuda")
    if "lookup" in only or "conv" in only:
        forward_shapes(cs, dev, only)
    if "backward" in only:
        backward_shapes(cs, dev)
    if "nn_band" in only:
        nn_band_shape(cs, dev)
    if "scatter8" in only:
        scatter8_shapes(cs, dev)
    if "gather8" in only:
        gather8_shapes(cs, dev)
    if "probes" in only:
        probe_shapes(cs, dev)
    if "digests" in only:
        digests(cs, dev)


def forward_shapes(cs, dev, only) -> None:
    """The lookup per level and the conv per shape of one B = 4 forward."""
    import numpy as np
    import torch

    from lidal_tpu_torch.config import SK_CONFIG
    from lidal_tpu_torch.data.pipeline import prepare_eval_batch
    from lidal_tpu_torch.models.minkunet import MinkUNet
    from lidal_tpu_torch.ops import cuda_conv, cuda_merge
    from lidal_tpu_torch.ops.hashing import key64
    from lidal_tpu_torch.ops.kernel_map import rulebook_streams

    batch = cs.make_batch(np.random.default_rng(0), SK_CONFIG.point_cap)
    eb = prepare_eval_batch(torch.Generator().manual_seed(0),
                            *(torch.as_tensor(batch[k], device=dev) for k in ("xyz", "sig", "valid")),
                            level_caps=SK_CONFIG.level_caps)

    k_sum = lib_sum = 0.0
    for lvl, lv in enumerate(eb.plan.levels if "lookup" in only else ()):
        streams = rulebook_streams(lv.coords, lv.valid)
        for found in (True, False):
            cs.require(torch.equal(cuda_merge.lookup_sorted(*streams, with_found=found),
                                   cuda_merge.lookup_sorted_plain(*streams, with_found=found)),
                       f"lookup level {lvl} found={found}")
        k_ms = cs.cuda_ms(lambda: cuda_merge.lookup_sorted(*streams, with_found=True), reps=20)
        tk = key64(streams[0], streams[1])
        qk = key64(streams[2], streams[3]).reshape(tk.shape[0], -1)
        lib_ms = cs.cuda_ms(lambda: torch.searchsorted(tk, qk), reps=20)
        wide = cuda_merge.wide_tiles(*streams) if hasattr(cuda_merge, "wide_tiles") else "not counted"
        print(f"lookup level {lvl} {tuple(streams[2].shape)}: kernel {k_ms:.4f} ms, searchsorted {lib_ms:.4f} ms, "
              f"wide tiles {wide}")
        k_sum += k_ms
        lib_sum += lib_ms
    if "lookup" in only:
        print(f"lookup, 5 levels: kernel {k_sum:.4f} ms, searchsorted {lib_sum:.4f} ms")
        if "conv" not in only:
            return

    torch.manual_seed(0)
    model = MinkUNet(num_classes=SK_CONFIG.num_classes).eval()
    cs.randomise_bn(model, 1)
    model = model.to(dev)
    captured, calls = {}, {}
    kernel = cuda_conv.subm_conv

    def recorder(feats, w, nbr, scale=None, shift=None, relu=False):
        key = (nbr.shape[1], feats.shape[1], w.shape[2], relu, nbr.shape[0], feats.shape[0])
        calls[key] = calls.get(key, 0) + 1
        captured.setdefault(key, (feats.clone(), w.clone(), nbr.clone(), scale.clone(), shift.clone(), relu))
        return kernel(feats, w, nbr, scale, shift, relu)

    cuda_conv.subm_conv = recorder
    try:
        with torch.inference_mode():
            model(eb.feats, eb.plan)
    finally:
        cuda_conv.subm_conv = kernel

    total = {"ms": 0.0, "real": 0.0, "dense": 0.0}
    with torch.inference_mode():
        for key in sorted(captured):
            args = captured[key]
            k, cin, cout, _, m, n = key
            nbr = args[2]
            ok, err = cs.conv_close(kernel(*args), cuda_conv.subm_conv_plain(*args))
            cs.require(ok, f"conv {key}: max |kernel - plain| {err}")
            ms = cs.cuda_ms(lambda: kernel(*args), reps=10)
            rows = _tile_rows(cout)
            real = (nbr < n).reshape(-1, k)
            tiles = torch.cat([real, real.new_zeros(((-m) % rows, k))]).reshape(-1, rows, k)
            flop = 2.0 * cin * cout
            real_gf = float(real.sum()) * flop / 1e9
            dense_gf = float(tiles.any(1).sum()) * rows * flop / 1e9
            c = calls[key]
            total["ms"] += c * ms
            total["real"] += c * real_gf
            total["dense"] += c * dense_gf
            print(f"conv K={k} cin={cin} cout={cout} m={m} n={n} x{c}: {ms:.3f} ms, max|d| {err:.1e}; "
                  f"GFLOP real {real_gf:.2f}, dense {rows}-row tiles {dense_gf:.2f}; "
                  f"{dense_gf / ms:.1f} TFLOP/s on the dense work")
    print(f"conv per forward: {total['ms']:.2f} ms; GFLOP real {total['real']:.1f}, dense {total['dense']:.1f}; "
          f"{total['dense'] / total['ms']:.1f} TFLOP/s on the dense work")
    del model, eb, captured
    torch.cuda.empty_cache()


def backward_shapes(cs, dev) -> None:
    """The conv backward kernel per shape of one B = 5 train step, dx and dW apart."""
    import numpy as np
    import torch

    from lidal_tpu_torch.config import SK_CONFIG, RunConfig
    from lidal_tpu_torch.data.pipeline import prepare_train_batch
    from lidal_tpu_torch.ops import cuda_conv_dxdw
    from lidal_tpu_torch.runtime.train import train_step
    from lidal_tpu_torch.runtime.train_loop import init_state

    batch = cs.make_batch(np.random.default_rng(0), SK_CONFIG.point_cap, SK_CONFIG.batch_size)
    tb = prepare_train_batch(torch.Generator().manual_seed(0),
                             *(torch.as_tensor(batch[k], device=dev) for k in ("xyz", "sig", "valid", "labels")),
                             level_caps=SK_CONFIG.level_caps)
    state = init_state(RunConfig(dataset_name="SK", model_name="Mink", seed=0), dev)
    captured, calls = {}, {}
    kernel, plain = cuda_conv_dxdw.conv_dx_dw, cuda_conv_dxdw.conv_dx_dw_plain

    def recorder(src, w2, nbr, f, need_dx=True):
        key = (nbr.shape[1], src.shape[1], w2.shape[2], f.shape[1], nbr.shape[0], src.shape[0], bool(need_dx))
        calls[key] = calls.get(key, 0) + 1
        captured.setdefault(key, (src.clone(), w2.clone(), nbr.clone(), f.clone(), bool(need_dx)))
        return kernel(src, w2, nbr, f, need_dx)

    cuda_conv_dxdw.conv_dx_dw = recorder
    try:
        train_step(state, tb)
    finally:
        cuda_conv_dxdw.conv_dx_dw = kernel
    del state, tb
    total = {"ms": 0.0, "dw": 0.0, "gflop": 0.0}
    for key in sorted(captured):
        src, w2, nbr, f, need_dx = args = captured[key]
        k, c_src, c_dst, c_f, m, n, _ = key
        for nd in sorted({need_dx, False}):
            got = kernel(src, w2, nbr, f, nd)
            want = plain(src, w2, nbr, f, nd)
            bound = plain(src.abs(), w2.abs(), nbr, f.abs(), nd)
            for name, g, p, b in zip(("dx", "dwg"), got, want, bound):
                if g is not None:
                    cs.require(bool(((g - p).abs() <= cs.CONV_TOL * b).all()), f"conv_dx_dw {key} {name}")
        ms = cs.cuda_ms(lambda: kernel(*args), reps=10)
        dw_ms = cs.cuda_ms(lambda: kernel(src, w2, nbr, f, False), reps=10) if need_dx else ms
        pairs = int(((nbr >= 0) & (nbr < n)).sum())
        gflop = 2.0 * pairs * c_f * c_src / 1e9
        c = calls[key]
        total["ms"] += c * ms
        total["dw"] += c * dw_ms
        total["gflop"] += c * gflop
        print(f"conv_dx_dw K={k} c_src={c_src} c_dst={c_dst} c_f={c_f} m={m} n={n} dx={int(need_dx)} x{c}: "
              f"{ms:.3f} ms (dx {ms - dw_ms:.3f}, dW {dw_ms:.3f}); {pairs} real pairs, dW GFLOP {gflop:.2f}, "
              f"{gflop / dw_ms:.1f} TFLOP/s")
    print(f"conv_dx_dw per step: {total['ms']:.2f} ms (dx {total['ms'] - total['dw']:.2f}, dW {total['dw']:.2f}); "
          f"dW GFLOP on real pairs {total['gflop']:.1f}, {total['gflop'] / total['dw']:.1f} TFLOP/s")


def nn_band_shape(cs, dev) -> None:
    """nn_band at phase 11's shape: 26 registered frames' grids, one of them the query."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lidal_tpu_torch.active import lidal, nn_match
    from lidal_tpu_torch.config import SK_CONFIG, RunConfig
    from lidal_tpu_torch.ops import cuda_nnband
    from lidal_tpu_torch.prep.grid import load_grid_points, prepare_sk_grids
    from lidal_tpu_torch.runtime.paths import Paths

    root = tempfile.mkdtemp(prefix="nn_band_shape_")
    try:
        data = dataclasses.replace(SK_CONFIG, train_split=("00",), val_split=("08",),
                                   train_point_num=cs.ROUND_FRAMES * cs.N_PTS)
        cfg = RunConfig(dataset_name="SK", model_name="Mink", label_unit="sv", metric_name="LiDAL", r_id=2,
                        inf_reps=8, seed=cs.SEED, data_root=os.path.join(root, "sequences"),
                        processing_root=os.path.join(root, "Processing_files"),
                        checkpoint_root=os.path.join(root, "check_points"), data_override=data)
        cs.write_round_tree(root, np.random.default_rng(cs.SEED + 6), cfg)
        prepare_sk_grids(cfg)
        cap, slots = cfg.data.point_cap, lidal.NEI_NUM + 2
        valid = torch.arange(cap, device=dev) < cs.N_PTS
        grids = []
        with torch.inference_mode():
            for i in range(slots):
                pad = np.zeros((cap, 3), np.float32)
                pad[: cs.N_PTS] = load_grid_points(os.path.join(Paths(cfg).grid_dir("00"), f"{i:06d}.npz"))
                grids.append(nn_match.build_grid(torch.from_numpy(pad).to(dev), valid, lidal.DIS_THRESH))
            pq = nn_match.prepared_from_grid(grids[slots // 2])
            grids = nn_match.stack_grids(grids)
            args = (grids.planar, pq.q_t, *nn_match.band_bounds(grids, pq))
            d2, row = cuda_nnband.nn_band(*args)
            d2_p, row_p = cuda_nnband.nn_band_plain(*args)
            cs.require(torch.equal(d2, d2_p) and torch.equal(row, row_p), "nn_band differs from the plain version")
            ms = cs.cuda_ms(lambda: cuda_nnband.nn_band(*args), reps=20)
            band = int(args[3].long().sum()) * cuda_nnband.TN * cuda_nnband.TILE
            pairs = cuda_nnband.nn_band_counted(*args)[2] if hasattr(cuda_nnband, "nn_band_counted") else band
        print(f"nn_band {slots} slots x {cap} queries: {ms:.4f} ms, bit-equal to the plain version; {band:.4e} pairs in "
              f"the bands, {pairs:.4e} evaluated ({pairs / band:.4f}), {pairs / (ms * 1e-3):.4e} pairs/s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def _device_split(fn, reps: int = 5) -> str:
    """Device ms per call of each kernel that ``fn`` launches, and their sum, from
    ``torch.profiler`` (CUPTI); "not measured" where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((us / reps / 1e3, e.key[:48]))
    if not rows:
        return "not measured"
    return ", ".join(f"{name} {ms:.4f}" for ms, name in sorted(rows, reverse=True)) + f"; in all {sum(r[0] for r in rows):.4f}"


def scatter8_shapes(cs, dev) -> None:
    """scatter8 at both shapes of one SPVCNN train step and on their full maps."""
    import numpy as np
    import torch

    from lidal_tpu_torch.config import SK_CONFIG, RunConfig
    from lidal_tpu_torch.data.pipeline import prepare_train_batch
    from lidal_tpu_torch.ops import cuda_gather8
    from lidal_tpu_torch.runtime.train import train_step
    from lidal_tpu_torch.runtime.train_loop import init_state

    batch = cs.make_batch(np.random.default_rng(0), SK_CONFIG.point_cap, SK_CONFIG.batch_size)
    tb = prepare_train_batch(torch.Generator().manual_seed(0),
                             *(torch.as_tensor(batch[k], device=dev) for k in ("xyz", "sig", "valid", "labels")),
                             level_caps=SK_CONFIG.level_caps, with_points=True)
    state = init_state(RunConfig(dataset_name="SK", model_name="SPVCNN", seed=0), dev)
    captured = {}
    kernel, plain = cuda_gather8.scatter8, cuda_gather8.scatter8_plain

    def recorder(dy, nbr, w8, n, *route):  # route: the bf16 flag of packages that have one
        captured[(dy.shape[0], n, dy.shape[1])] = (dy.clone(), nbr.clone(), w8.clone(), n)
        return kernel(dy, nbr, w8, n, *route)

    cuda_gather8.scatter8 = recorder
    try:
        train_step(state, tb, cs.DROPOUT_SEEDS[: len(tb.feats)])
    finally:
        cuda_gather8.scatter8 = kernel
    del state, tb
    transpose = getattr(cuda_gather8, "transpose_map", cuda_gather8.build_transpose)
    total = {"ms": 0.0, "map": 0.0}
    for key in sorted(captured):
        for full in (False, True):
            m, n, c = key
            dy, nbr, w8, _ = captured[key] if not full else (*cs.dense_map_inputs(m, m, c, dev, targets=n), n)
            got = kernel(dy, nbr, w8, n)
            abs_sum = plain(dy.abs(), nbr, w8.abs(), n)
            cs.require(bool(((got - plain(dy, nbr, w8, n)).abs() <= cs.SCATTER_TOL * abs_sum).all()), f"scatter8 {key}")
            del abs_sum
            ms = cs.cuda_ms(lambda: kernel(dy, nbr, w8, n), reps=10)
            map_ms = cs.cuda_ms(lambda: transpose(nbr, n), reps=10)
            pairs = int(((nbr >= 0) & (nbr < n)).sum())
            split = _device_split(lambda: kernel(dy, nbr, w8, n))
            if not full:
                total["ms"] += ms
                total["map"] += map_ms
            print(f"scatter8 m={m} n={n} c={c}{' full map' if full else ''}: {ms:.4f} ms, of which the transposed map "
                  f"{map_ms:.4f} ms; {pairs} real pairs; device time by kernel (profiler): {split}")
    print(f"scatter8 per step: {total['ms']:.4f} ms, of which the transposed maps {total['map']:.4f} ms")
    if hasattr(cuda_gather8, "transpose_map"):  # one target takes every pair: the segment sort's worst case
        for pairs in (1 << 16, 1 << 18, 1 << 20):
            nbr = torch.zeros((pairs // 8, 8), dtype=torch.int32, device=dev)
            order, _ = transpose(nbr, 1)
            cs.require(torch.equal(order, torch.arange(pairs, dtype=torch.int32, device=dev)), f"one segment of {pairs}")
            print(f"transposed map with one segment of {pairs} ids: {cs.cuda_ms(lambda: transpose(nbr, 1), reps=3):.4f} ms, "
                  f"torch.sort + searchsorted {cs.cuda_ms(lambda: cuda_gather8.build_transpose(nbr, 1), reps=3):.4f} ms")


def _route(on: bool):
    """ROOT's ``ops/conv.bf16_route(on)``: the route's switch set, and restored after."""
    from lidal_tpu_torch.ops import conv

    return conv.bf16_route(on)


def _spvcnn_eval_batch(cs, dev):
    import numpy as np
    import torch

    from lidal_tpu_torch.config import SK_CONFIG
    from lidal_tpu_torch.data.pipeline import prepare_eval_batch

    batch = cs.make_batch(np.random.default_rng(0), SK_CONFIG.point_cap)
    return prepare_eval_batch(torch.Generator().manual_seed(0),
                              *(torch.as_tensor(batch[k], device=dev) for k in ("xyz", "sig", "valid")),
                              level_caps=SK_CONFIG.level_caps, with_points=True)


def gather8_shapes(cs, dev) -> None:
    """SPVCNN's point transfers of one B = 4 forward and scatter8's calls of
    one B = 5 train step, on both routes."""
    import numpy as np
    import torch

    from lidal_tpu_torch.config import SK_CONFIG, RunConfig
    from lidal_tpu_torch.data.pipeline import forward_batch, prepare_train_batch
    from lidal_tpu_torch.models import spvcnn as spv
    from lidal_tpu_torch.ops import cuda_gather8
    from lidal_tpu_torch.runtime.train import train_step
    from lidal_tpu_torch.runtime.train_loop import init_state

    eb = _spvcnn_eval_batch(cs, dev)
    torch.manual_seed(0)
    model = spv.SPVCNN(num_classes=SK_CONFIG.num_classes).eval().to(dev)
    casts = not hasattr(cuda_gather8, "child_sum")  # the route's wrappers cast their tables to bf16
    m0 = eb.plan.levels[0].coords.shape[0] * eb.plan.levels[0].coords.shape[1]
    names = ("gather8_forward", "child_sum") if not casts else ("gather8_forward",)
    for on in (False, True):
        calls, inner = [], []
        outer = spv.devoxelize_trilinear_batched, spv.point_to_voxel_avg_batched
        wrappers = {name: getattr(cuda_gather8, name) for name in names}

        def rec(fn, store):
            def call(*args, **kwargs):
                args = args + tuple(kwargs.values())  # the calls pass their last arguments by name or by place
                store.append((fn, tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)))
                return fn(*args)
            return call

        spv.devoxelize_trilinear_batched, spv.point_to_voxel_avg_batched = (rec(f, calls) for f in outer)
        for name, fn in wrappers.items():
            setattr(cuda_gather8, name, rec(fn, inner))
        try:
            with torch.inference_mode(), _route(on):
                forward_batch(model, eb)
        finally:
            spv.devoxelize_trilinear_batched, spv.point_to_voxel_avg_batched = outer
            for name, fn in wrappers.items():
                setattr(cuda_gather8, name, fn)
        label = "bf16 route" if on else "f32"
        total = {"calls": 0.0, "wrappers": 0.0, "casts": 0.0}
        with torch.inference_mode(), _route(on):
            for fn, args in calls:
                ms = cs.cuda_ms(lambda: fn(*args), reps=10)
                total["calls"] += ms
                print(f"gather8 {label}: {fn.__name__} {tuple(args[0].shape)} -> as the model calls it {ms:.4f} ms")
            for fn, args in inner:
                ms = cs.cuda_ms(lambda: fn(*args), reps=10)
                total["wrappers"] += ms
                cast = cs.cuda_ms(lambda: args[0].to(torch.bfloat16), reps=10) if on and casts else 0.0
                total["casts"] += cast
                print(f"gather8 {label}: {fn.__name__} {tuple(args[0].shape)}: wrapper {ms:.4f} ms"
                      + (f", of which the table's cast {cast:.4f} ms" if cast else ""))
        print(f"gather8 {label} per forward: {len(calls)} transfers {total['calls']:.4f} ms; {len(inner)} wrapper "
              f"calls {total['wrappers']:.4f} ms" + (f", casts {total['casts']:.4f} ms, kernels "
                                                      f"{total['wrappers'] - total['casts']:.4f} ms" if on and casts else ""))
    del model, eb
    batch = cs.make_batch(np.random.default_rng(0), SK_CONFIG.point_cap, SK_CONFIG.batch_size)
    tb = prepare_train_batch(torch.Generator().manual_seed(0),
                             *(torch.as_tensor(batch[k], device=dev) for k in ("xyz", "sig", "valid", "labels")),
                             level_caps=SK_CONFIG.level_caps, with_points=True)
    kernel = cuda_gather8.scatter8
    for on in (False, True):
        captured = []

        def recorder(dy, nbr, w8, n, *route):
            captured.append((dy.clone(), nbr.clone(), w8.clone(), n, *route))
            return kernel(dy, nbr, w8, n, *route)

        state = init_state(RunConfig(dataset_name="SK", model_name="SPVCNN", seed=0), dev)
        cuda_gather8.scatter8 = recorder
        try:
            with _route(on):
                train_step(state, tb, cs.DROPOUT_SEEDS[: len(tb.feats)])
        finally:
            cuda_gather8.scatter8 = kernel
        del state
        label = "bf16 route" if on else "f32"
        total = {"ms": 0.0, "cast": 0.0}
        for args in captured:
            ms = cs.cuda_ms(lambda: kernel(*args), reps=10)
            cast = cs.cuda_ms(lambda: args[0].to(torch.bfloat16), reps=10) if on and casts else 0.0
            total["ms"] += ms
            total["cast"] += cast
            print(f"scatter8 {label} m={args[0].shape[0]} n={args[3]} c={args[0].shape[1]}: wrapper {ms:.4f} ms"
                  + (f", of which the cast of dy {cast:.4f} ms" if cast else ""))
        print(f"scatter8 {label} per step: {len(captured)} calls {total['ms']:.4f} ms"
              + (f", casts {total['cast']:.4f} ms, kernels {total['ms'] - total['cast']:.4f} ms" if on and casts else ""))
    if hasattr(cs, "gather_work_phase"):
        eb = _spvcnn_eval_batch(cs, dev)
        torch.manual_seed(0)
        model = spv.SPVCNN(num_classes=SK_CONFIG.num_classes).eval().to(dev)
        cs.gather_work_phase(model, eb)
        cs.gather_work_phase(model, eb, route=True)
        del model, eb
    for c in (256, 128):
        out = torch.empty((m0, c), device=dev)
        print(f"zero_() of a [{m0}, {c}] f32 output ({out.numel() * 4 / 1e6:.0f} MB): "
              f"{cs.cuda_ms(lambda: out.zero_(), reps=20):.4f} ms")
        del out


def _rates(label, ms, real_flop, issued_flop) -> str:
    """ms, GFLOP and TFLOP/s on the real pairs and, where counted, on the products issued."""
    text = f"{label}: {ms:.4f} ms; real {real_flop / 1e9:.3f} GFLOP, {real_flop / ms / 1e9:.1f} TFLOP/s"
    if issued_flop is not None:
        text += (f"; issued {issued_flop / 1e9:.3f} GFLOP, {issued_flop / ms / 1e9:.1f} TFLOP/s, "
                 f"issue/real {issued_flop / max(real_flop, 1.0):.2f}")
    return text


def _compacted_ratio(nbr, n: int, window: int) -> float:
    """Products over real ones if the tile packed each tap's real rows of a
    window into groups of 64 (the rows of a wgmma): ceil(count / 64) x 64 rows
    per (window, tap), over the real (row, tap) pairs."""
    import torch

    m, k = nbr.shape
    real = ((nbr >= 0) & (nbr < n)).to(torch.int32)
    real = torch.cat([real, real.new_zeros(((-m) % window, k))]).reshape(-1, window, k)
    per = real.sum(1)
    return float(((per + 63) // 64 * 64).sum()) / max(float(per.sum()), 1.0)


def probe_shapes(cs, dev) -> None:
    """The three bf16 probe kernels at the probes' shapes, phase 19's real maps
    and the shapes of one B = 5 train step; digests of the f32 backward."""
    import hashlib

    import numpy as np
    import torch

    from lidal_tpu_torch.config import SK_CONFIG, RunConfig
    from lidal_tpu_torch.data.pipeline import prepare_eval_batch, prepare_train_batch
    from lidal_tpu_torch.models.minkunet import MinkUNet
    from lidal_tpu_torch.ops import cuda_conv, cuda_conv_bf16 as cb, cuda_conv_dxdw, cuda_conv_dxdw_fused as fz
    from lidal_tpu_torch.runtime.train import train_step
    from lidal_tpu_torch.runtime.train_loop import init_state
    from lidal_tpu_torch.tools import probe_conv_v3, probe_dxdw_features, probe_int8_gather

    counted = hasattr(cb, "tile_products")

    def gather_first(label, feats, w, nbr, with_f32):
        n, cin = feats.shape
        cout = w.shape[2]
        table, wt = cb.pack_table(feats), cb.pack_weights(w)
        got = cb.gather_first_packed(table, wt, nbr)
        abs_sum = cb.conv_gather_first_plain(feats.abs(), w.abs(), nbr)
        cs.require(bool(((got - cb.conv_gather_first_plain(feats, w, nbr)).abs() <= 1e-5 * abs_sum).all()),
                   f"conv_gather_first {label}")
        cs.require(torch.equal(cb.gather_first_packed(table, wt, nbr, pipelined=True), got), f"pipelined {label}")
        del abs_sum
        real = 2.0 * int(((nbr >= 0) & (nbr < n)).sum()) * cin * cout
        issued = 2.0 * cb.tile_products(nbr, n, table.shape[1], cout) if counted else None
        ms = cs.cuda_ms(lambda: cb.gather_first_packed(table, wt, nbr), reps=20)
        piped = cs.cuda_ms(lambda: cb.gather_first_packed(table, wt, nbr, pipelined=True), reps=20)
        wrapper = cs.cuda_ms(lambda: cb.conv_gather_first(feats, w, nbr), reps=20)
        line = _rates(f"conv_gather_first {label} K={nbr.shape[1]} cin={cin} cout={cout} m={nbr.shape[0]} n={n}",
                      ms, real, issued) + f"; pipelined {piped:.4f} ms, wrapper {wrapper:.4f} ms"
        f32 = cs.cuda_ms(lambda: cuda_conv.subm_conv(feats, w, nbr), reps=20) if with_f32 else None
        print(line + (f"; f32 subm_conv {f32:.4f} ms" if f32 is not None else ""))
        return ms, piped, f32

    with torch.inference_mode():
        rng = np.random.default_rng(0)  # the probe's generator and order of draws
        total = [0.0, 0.0]
        for n, cin, cout, label in probe_conv_v3.SHAPES:
            nbr = torch.from_numpy(probe_conv_v3.make_nbr(rng, n, 27, max(300, n // 40))).to(dev)
            feats = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32)).to(dev)
            w = torch.from_numpy((rng.standard_normal((27, cin, cout)) * 0.05).astype(np.float32)).to(dev)
            ms, piped, _ = gather_first(f"probe {label}", feats, w, nbr, False)
            total = [total[0] + ms, total[1] + piped]
        print(f"conv_gather_first, the probe's six shapes, kernel alone: {total[0]:.4f} ms, pipelined {total[1]:.4f} ms")

        rng = np.random.default_rng(0)
        n = probe_int8_gather.N
        total = [0.0, 0.0]
        for cin, cout in probe_int8_gather.SHAPES:
            feats = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32)).to(dev)
            w = torch.from_numpy((0.1 * rng.standard_normal((27, cin, cout))).astype(np.float32)).to(dev)
            nbr = torch.from_numpy(probe_int8_gather.make_nbr(rng, n, 27, max(300, n // 40))).to(dev)
            planes, table, wt = cb.to_byte_planes(feats), cb.pack_table(feats), cb.pack_weights(w)
            cs.require(torch.equal(cb.byte_planes_packed(planes, wt, nbr), cb.gather_first_packed(table, wt, nbr)),
                       f"byte planes c{cin}")
            k_ms = cs.cuda_ms(lambda: cb.byte_planes_packed(planes, wt, nbr), reps=20)
            t_ms = cs.cuda_ms(lambda: cb.gather_first_packed(table, wt, nbr), reps=20)
            total = [total[0] + k_ms, total[1] + t_ms]
            print(f"conv_byte_planes c{cin}->{cout} n={n}: {k_ms:.4f} ms, bf16 table {t_ms:.4f} ms")
        print(f"conv_byte_planes, the probe's two shapes: {total[0]:.4f} ms, bf16 table {total[1]:.4f} ms")

        # phase 19's three real maps, from one B = 4 forward
        batch = cs.make_batch(np.random.default_rng(0), SK_CONFIG.point_cap)
        eb = prepare_eval_batch(torch.Generator().manual_seed(0),
                                *(torch.as_tensor(batch[k], device=dev) for k in ("xyz", "sig", "valid")),
                                level_caps=SK_CONFIG.level_caps)
        torch.manual_seed(0)
        model = MinkUNet(num_classes=SK_CONFIG.num_classes).eval().to(dev)
        captured = {}
        kernel = cuda_conv.subm_conv

        def recorder(feats, w, nbr, scale=None, shift=None, relu=False):
            key = (nbr.shape[1], feats.shape[1], w.shape[2], relu, nbr.shape[0], feats.shape[0])
            captured.setdefault(key, (feats.clone(), w.clone(), nbr.clone()))
            return kernel(feats, w, nbr, scale, shift, relu)

        cuda_conv.subm_conv = recorder
        try:
            model(eb.feats, eb.plan)
        finally:
            cuda_conv.subm_conv = kernel
        picks = {
            "forward K=27": max((kk for kk in captured if kk[0] == 27), key=lambda kk: (kk[4], kk[1] * kk[2])),
            "forward down": max((kk for kk in captured if kk[0] == 8 and kk[4] < kk[5]), key=lambda kk: (kk[5], kk[1] * kk[2])),
            "forward up": max((kk for kk in captured if kk[0] == 8 and kk[4] > kk[5]), key=lambda kk: (kk[4], kk[1] * kk[2])),
        }
        for label, kk in picks.items():
            gather_first(label, *captured[kk], True)
            feats, w, nbr = captured[kk]
            ratios = ", ".join(f"{rows} rows {_compacted_ratio(nbr, feats.shape[0], rows):.2f}" for rows in (128, 384, 1024))
            print(f"  {label}: issue/real if each tap's real rows of a window were packed into 64-row wgmma groups: {ratios}")
        del model, eb, captured

    # the fused backward at the probe's shapes and at one train step's
    rng = np.random.default_rng(0)
    cases = [("probe", probe_dxdw_features.probe_inputs(rng), 1)]
    cases += [(f"probe {label}", probe_dxdw_features.step_inputs(rng, *shape), 1)
              for label, *shape in probe_dxdw_features.STEP_SHAPES]
    cases = [(label, tuple(torch.from_numpy(a).to(dev) for a in arrays), c) for label, arrays, c in cases]
    batch = cs.make_batch(np.random.default_rng(0), SK_CONFIG.point_cap, SK_CONFIG.batch_size)
    tb = prepare_train_batch(torch.Generator().manual_seed(0),
                             *(torch.as_tensor(batch[k], device=dev) for k in ("xyz", "sig", "valid", "labels")),
                             level_caps=SK_CONFIG.level_caps)
    state = init_state(RunConfig(dataset_name="SK", model_name="Mink", seed=0), dev)
    step, calls = {}, {}
    f32 = cuda_conv_dxdw.conv_dx_dw

    def recorder(src, w2, nbr, f, need_dx=True):
        key = (nbr.shape[1], src.shape[1], w2.shape[2], f.shape[1], nbr.shape[0], src.shape[0], bool(need_dx))
        calls[key] = calls.get(key, 0) + 1
        step.setdefault(key, (src.clone(), w2.clone(), nbr.clone(), f.clone()))
        return f32(src, w2, nbr, f, need_dx)

    cuda_conv_dxdw.conv_dx_dw = recorder
    try:
        train_step(state, tb)
    finally:
        cuda_conv_dxdw.conv_dx_dw = f32
    del state, tb
    cases += [(f"step K={key[0]} dx={int(key[6])}", step[key], calls[key]) for key in sorted(step)]
    totals = {"probe": [0.0, 0.0], "step": [0.0, 0.0, 0.0]}
    for label, (src, w2, nbr, f), c in cases:
        (n, c_src), (m, k), c_dst, c_f = src.shape, nbr.shape, w2.shape[2], f.shape[1]
        dx, dw = fz.conv_dx_dw_fused(src, w2, nbr, f, "dx_dw")
        want = fz.conv_dx_dw_fused_plain(src, w2, nbr, f)
        bound = fz.conv_dx_dw_fused_plain(src.abs(), w2.abs(), nbr, f.abs())
        for name, g, p, b in zip(("dx", "dw"), (dx, dw), want, bound):
            cs.require(bool(((g - p).abs() <= 1e-5 * b).all()), f"conv_dx_dw_fused {label} {name}")
        del dx, dw, want, bound
        ms = cs.cuda_ms(lambda: fz.conv_dx_dw_fused(src, w2, nbr, f, "dx_dw"), reps=5)
        dx_ms = cs.cuda_ms(lambda: fz.conv_dx_dw_fused(src, w2, nbr, f, "dx"), reps=5)
        pairs = int(((nbr >= 0) & (nbr < n)).sum())
        real = 2.0 * pairs * c_src * (c_dst + c_f)
        issued = None
        if counted:
            cs_, cd_, cf_ = fz.padded_channels(c_src, c_dst, c_f)
            issued = 2.0 * (cb.tile_products(nbr, n, cs_, cd_) + pairs * cs_ * cf_)
        line = _rates(f"conv_dx_dw_fused {label} K={k} c_src={c_src} c_dst={c_dst} c_f={c_f} m={m} n={n} x{c}",
                      ms, real, issued) + f"; dx {dx_ms:.4f} ms, dW {ms - dx_ms:.4f} ms"
        if m * c_src >= 655360 * 96:  # the level-0 shapes: where the time goes, kernel by kernel
            line += f"; device time by kernel (profiler): {_device_split(lambda: fz.conv_dx_dw_fused(src, w2, nbr, f, 'dx_dw'))}"
        if label.startswith("probe"):
            totals["probe"] = [totals["probe"][0] + ms, totals["probe"][1] + dx_ms]
        else:
            f_ms = cs.cuda_ms(lambda: f32(src, w2, nbr, f, label.endswith("dx=1")), reps=5)  # as the step calls it
            totals["step"] = [totals["step"][0] + c * ms, totals["step"][1] + c * dx_ms, totals["step"][2] + c * f_ms]
            line += f"; f32 conv_dx_dw {f_ms:.4f} ms"
        print(line)
    steps = [(args, c) for label, args, c in cases if not label.startswith("probe")]
    print(f"conv_dx_dw_fused, the probe's three shapes: dx_dw {totals['probe'][0]:.3f} ms, dx {totals['probe'][1]:.3f} ms")
    print(f"conv_dx_dw_fused over one step's calls, device time by kernel (profiler): "
          f"{_device_split(lambda: [fz.conv_dx_dw_fused(*a, 'dx_dw') for a, c in steps for _ in range(c)], reps=2)}")
    print(f"conv_dx_dw_fused per B = 5 step ({len(step)} shapes, {sum(calls.values())} calls): dx_dw "
          f"{totals['step'][0]:.3f} ms, dx {totals['step'][1]:.3f} ms; f32 conv_dx_dw {totals['step'][2]:.3f} ms")
    del cases, step

    # digests of the f32 backward on seeded inputs
    rng = np.random.default_rng(1)
    inputs = [probe_dxdw_features.step_inputs(rng, *shape) for _, *shape in probe_dxdw_features.STEP_SHAPES]
    m, n = 200000, 150000
    nbr = rng.integers(0, n, (m, 27)).astype(np.int32)
    nbr[rng.random((m, 27)) >= 0.04] = n
    inputs.append((rng.standard_normal((n, 96), dtype=np.float32),
                   (rng.standard_normal((27, 96, 64), dtype=np.float32) / 50).astype(np.float32), nbr,
                   rng.standard_normal((m, 32), dtype=np.float32)))
    for arrays in inputs:
        src, w2, nbr, f = (torch.from_numpy(a).to(dev) for a in arrays)
        dx, dwg = f32(src, w2, nbr, f)
        print(f"f32 conv_dx_dw digest c_src={src.shape[1]} c_dst={w2.shape[2]} c_f={f.shape[1]} m={nbr.shape[0]}: dx "
              f"{hashlib.sha256(dx.cpu().numpy().tobytes()).hexdigest()[:16]}, dwg "
              f"{hashlib.sha256(dwg.cpu().numpy().tobytes()).hexdigest()[:16]}")


def digests(cs, dev) -> None:
    """sha256 of each kernel's outputs on seeded inputs (the ``digests`` section)."""
    import hashlib

    import numpy as np
    import torch

    from lidal_tpu_torch.ops import cuda_conv, cuda_conv_bf16, cuda_conv_dxdw, cuda_conv_dxdw_fused, cuda_gather8

    def sha(*tensors) -> str:
        return ", ".join(hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16] for t in tensors)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(3)
    n = m = 400000
    nbr = rng.integers(0, n, (m, 27)).astype(np.int32)
    nbr[rng.random((m, 27)) >= 0.04] = n
    nbr, feats = t(nbr), t(rng.standard_normal((n, 64), dtype=np.float32))
    w = t((rng.standard_normal((27, 64, 96), dtype=np.float32) / 40).astype(np.float32))
    scale, shift = t(rng.uniform(0.5, 1.5, 96).astype(np.float32)), t(rng.normal(scale=0.1, size=96).astype(np.float32))
    print(f"digest subm_conv K=27 64->96 m={m}: none {sha(cuda_conv.subm_conv(feats, w, nbr))}, affine + relu "
          f"{sha(cuda_conv.subm_conv(feats, w, nbr, scale, shift, True))}")
    print(f"digest conv_gather_first K=27 64->96 m={m}: {sha(cuda_conv_bf16.conv_gather_first(feats, w, nbr))}")
    dy = t(rng.standard_normal((m, 96), dtype=np.float32))
    w2 = w.transpose(1, 2).contiguous()
    print(f"digest conv_dx_dw c_src=96 c_dst=64 c_f=64 m={m}: dx, dwg {sha(*cuda_conv_dxdw.conv_dx_dw(dy, w2, nbr, feats))}; "
          f"dwg alone {sha(cuda_conv_dxdw.conv_dx_dw(dy, w2, nbr, feats, False)[1])}")
    print(f"digest conv_dx_dw_fused dx_dw c_src=96 c_dst=64 c_f=64 m={m}: "
          f"{sha(*cuda_conv_dxdw_fused.conv_dx_dw_fused(dy, w2, nbr, feats, 'dx_dw'))}")
    m8, n8 = 480000, 12000
    nbr8 = rng.integers(0, n8, (m8, 8)).astype(np.int32)
    nbr8[rng.random((m8, 8)) >= 0.7] = n8
    nbr8, w8 = t(nbr8), t(rng.random((m8, 8), dtype=np.float32))
    table, dy8 = t(rng.standard_normal((n8, 256), dtype=np.float32)), t(rng.standard_normal((m8, 128), dtype=np.float32))
    print(f"digest gather8 m={m8} n={n8} c=256: {sha(cuda_gather8.gather8_forward(table, nbr8, w8))}")
    print(f"digest scatter8 m={m8} n={n8} c=128: {sha(cuda_gather8.scatter8(dy8, nbr8, w8, n8))}")
    print(f"digest gather8 bf16 table m={m8} n={n8} c=256: {sha(cuda_gather8.gather8_forward(table, nbr8, w8, True))}")
    print(f"digest scatter8 bf16 rows m={m8} n={n8} c=128: {sha(cuda_gather8.scatter8(dy8, nbr8, w8, n8, True))}")
    # SPVCNN's point transfers on a B = 4 plan, both routes, forward and gradient
    from lidal_tpu_torch.ops import devoxelize

    eb = _spvcnn_eval_batch(cs, dev)
    g = torch.Generator().manual_seed(4)
    valid0 = eb.plan.levels[0].valid[..., None]
    for on in (False, True):
        with _route(on):
            for name, lvl, c in (("tri2", 2, 128), ("tri4", 4, 256)):
                vf = torch.randn((eb.plan.levels[lvl].coords.shape[:2]) + (c,), generator=g).to(dev).requires_grad_(True)
                out = devoxelize.devoxelize_trilinear_batched(vf, getattr(eb.pplan, name))
                (grad,) = torch.autograd.grad(out, vf, torch.randn(out.shape, generator=g).to(dev))
                print(f"digest devoxelize_trilinear_batched {name} c={c}{' bf16 route' if on else ''}: "
                      f"{sha(out.detach(), grad)}")
            for name, lvl, c in (("avg2", 2, 128), ("avg4", 4, 256)):
                pf = (torch.randn(valid0.shape[:2] + (c,), generator=g).to(dev) * valid0).requires_grad_(True)
                out = devoxelize.point_to_voxel_avg_batched(pf, eb.plan.downs, getattr(eb.pplan, name), lvl)
                (grad,) = torch.autograd.grad(out, pf, torch.randn(out.shape, generator=g).to(dev))
                print(f"digest point_to_voxel_avg_batched {name} c={c}{' bf16 route' if on else ''}: "
                      f"{sha(out.detach(), grad)}")


if __name__ == "__main__":
    args = sys.argv[1:]
    only = SECTIONS
    if "--only" in args:
        i = args.index("--only")
        only = tuple(args[i + 1].split(","))
        del args[i : i + 2]
    main(args[0] if args else os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."), only)
