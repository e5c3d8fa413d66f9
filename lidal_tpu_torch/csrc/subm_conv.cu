// Gather-GEMM sparse convolution with the eval BatchNorm epilogue fused.
//
// Replaces lidal_tpu/ops/pallas_conv.py:subm_conv_pallas.  It computes
//
//   out[i] = sum_k feats[nbr[i, k]] @ w[k]          (f32; nbr >= n gives 0)
//
// and, with the epilogue, y = acc * scale + shift, then relu if asked, then 0
// on rows whose taps are all sentinel (pallas_conv.py:155-166).  One kernel
// serves every conv of MinkUNet: submanifold (K = 27), down (K = 8 via
// `child`) and transposed up (K = 8 via the per-tap parent map).  The tile
// kernel itself is gather_gemm.cuh, which conv_dx_dw.cu shares.
//
// The TPU kernel gathers with one-hot matmuls over banded DMA blocks, because
// Mosaic cannot index VMEM dynamically; none of that carries over.  Here each
// block owns a BM-row x BN-column output tile.  For every tap it gathers the
// tile's source rows straight from device memory into shared memory, KC
// channels at a time (zeros for the sentinel), stages w[k][chunk, cols] beside
// them, and accumulates a 4x4 f32 register tile per thread with FFMA.
//
// What bounds it on an H100: f32 FFMA issue and shared-memory reads (no TF32
// tensor cores, the port is f32 throughout).  A tap whose rows are all
// sentinel inside the tile is skipped, which removes the padded tail of each
// frame and absent neighbours.  wgmma with bf16 operands, TMA gathers and
// double buffering are left to later work.

#include "gather_gemm.cuh"

// feats [n, cin], w [k, cin, cout], nbr [m, k] int32, scale/shift [cout] (read
// only when epilogue > 0), out [m, cout]; all contiguous f32/int32 on the
// current device, feats/w/out 16-byte aligned.  epilogue: 0 none, 1 affine,
// 2 affine + relu.  Needs k <= 27, cin % 4 == 0, cout % 32 == 0.  Returns
// cudaGetLastError() after the launch.
extern "C" int lidal_subm_conv(const void* feats, const void* w, const void* nbr,
                               const void* scale, const void* shift, void* out, int m, int n,
                               int k, int cin, int cout, int epilogue, void* stream) {
  using namespace gather_gemm;
  if (m == 0) return (int)cudaSuccess;
  if (!shapes_ok(m, n, k, cin, cout) || epilogue < 0 || epilogue > 2)
    return (int)cudaErrorInvalidValue;
  const auto* f = (const float*)feats;
  const auto* wf = (const float*)w;
  const auto* nb = (const int*)nbr;
  const auto* sc = (const float*)scale;
  const auto* sh = (const float*)shift;
  auto* o = (float*)out;
  const auto s = (cudaStream_t)stream;
  const bool wide = cout % 64 == 0;
  switch (epilogue * 2 + (wide ? 1 : 0)) {
    case 0: return (int)launch<32, 0>(f, wf, nb, sc, sh, o, m, n, k, cin, cout, s);
    case 1: return (int)launch<64, 0>(f, wf, nb, sc, sh, o, m, n, k, cin, cout, s);
    case 2: return (int)launch<32, 1>(f, wf, nb, sc, sh, o, m, n, k, cin, cout, s);
    case 3: return (int)launch<64, 1>(f, wf, nb, sc, sh, o, m, n, k, cin, cout, s);
    case 4: return (int)launch<32, 2>(f, wf, nb, sc, sh, o, m, n, k, cin, cout, s);
    default: return (int)launch<64, 2>(f, wf, nb, sc, sh, o, m, n, k, cin, cout, s);
  }
}
