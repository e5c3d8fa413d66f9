"""Time the lookup and the conv kernel at the shapes of one B = 4 eval batch,
and the conv backward kernel at the shapes of one B = 5 train step.

    python3 lidal_tpu_torch/tools/kernel_shapes.py [ROOT]     # on an NVIDIA GPU

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
  the TFLOP/s reached; then the sums per step.
"""

from __future__ import annotations

import os
import subprocess
import sys


def _tile_rows(cout: int) -> int:
    """Rows of the conv kernel's tile at this cout (``Tile::BM`` of gather_gemm.cuh)."""
    return 64 if cout % 128 == 0 or cout % 96 == 0 else 128


def main(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from lidal_tpu_torch.config import SK_CONFIG
    from lidal_tpu_torch.data.pipeline import prepare_eval_batch
    from lidal_tpu_torch.models.minkunet import MinkUNet
    from lidal_tpu_torch.ops import cuda_conv, cuda_merge
    from lidal_tpu_torch.ops.hashing import key64
    from lidal_tpu_torch.ops.kernel_map import rulebook_streams

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: kernel_shapes times the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"package under {os.path.abspath(root)}")
    dev = torch.device("cuda")
    batch = cs.make_batch(np.random.default_rng(0), SK_CONFIG.point_cap)
    eb = prepare_eval_batch(torch.Generator().manual_seed(0),
                            *(torch.as_tensor(batch[k], device=dev) for k in ("xyz", "sig", "valid")),
                            level_caps=SK_CONFIG.level_caps)

    k_sum = lib_sum = 0.0
    for lvl, lv in enumerate(eb.plan.levels):
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
    print(f"lookup, 5 levels: kernel {k_sum:.4f} ms, searchsorted {lib_sum:.4f} ms")

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
    backward_shapes(cs, dev)


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


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
