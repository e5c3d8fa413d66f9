"""Time the lookup and the conv kernel at the shapes of one B = 4 eval batch,
and the conv backward kernel at the shapes of one B = 5 train step.

    python3 lidal_tpu_torch/tools/kernel_shapes.py [ROOT] [--only SECTIONS]   # on an NVIDIA GPU

SECTIONS is a comma-separated subset of ``lookup,conv,backward,nn_band,scatter8``
(default: all).

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
  whose every pair names one target (segments of 2^16, 2^18 and 2^20 ids).
"""

from __future__ import annotations

import os
import subprocess
import sys


def _tile_rows(cout: int) -> int:
    """Rows of the conv kernel's tile at this cout (``Tile::BM`` of gather_gemm.cuh)."""
    return 64 if cout % 128 == 0 or cout % 96 == 0 else 128


SECTIONS = ("lookup", "conv", "backward", "nn_band", "scatter8")


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
    """Device ms per call of each kernel that ``fn`` launches, from
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
    return ", ".join(f"{name} {ms:.4f}" for ms, name in sorted(rows, reverse=True)) or "not measured"


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

    def recorder(dy, nbr, w8, n):
        captured[(dy.shape[0], n, dy.shape[1])] = (dy.clone(), nbr.clone(), w8.clone(), n)
        return kernel(dy, nbr, w8, n)

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


if __name__ == "__main__":
    args = sys.argv[1:]
    only = SECTIONS
    if "--only" in args:
        i = args.index("--only")
        only = tuple(args[i + 1].split(","))
        del args[i : i + 2]
    main(args[0] if args else os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."), only)
