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
// Mosaic cannot index VMEM dynamically; none of that carries over.  Here a
// block owns a row tile and all of cout up to 128 columns, gathers each
// (row, tap) of its tile once per column tile with cp.async into shared
// memory, two stages in flight, and multiplies on the tensor cores in split
// TF32 (three tf32 products per f32 product), which keeps f32 accuracy.
//
// What bounds it on an H100: the split-TF32 products (495 / 3 TFLOP/s) at
// the wide convs, and the gathered bytes at the stem (cin = 4, 16 bytes a
// (row, tap)).  The f32 FFMA rate (67 TFLOP/s) no longer applies; the design
// answers the product bound with the tensor cores and the gather with
// asynchronous copies that overlap the products, each row fetched once per
// column tile.  Dense tiles do the products of sentinel (row, tap) pairs of
// an active tap as well, so the rate counted on real pairs is lower.
// wgmma (operands K-major in swizzled shared memory) is left to later work.

#include "gather_gemm.cuh"

// feats [n, cin], w [k, cin, cout], nbr [m, k] int32, order [m] int32 (a
// permutation of [0, m) that the row tiles walk, or null for the rows as they
// are), scale/shift [cout] (read
// only when epilogue > 0), out [m, cout]; all contiguous f32/int32 on the
// current device, feats/w/out 16-byte aligned.  epilogue: 0 none, 1 affine,
// 2 affine + relu.  Needs k <= 27, cin % 4 == 0, cout % 32 == 0.  Returns
// cudaGetLastError() after the launch.
extern "C" int lidal_subm_conv(const void* feats, const void* w, const void* nbr, const void* order,
                               const void* scale, const void* shift, void* out, int m, int n,
                               int k, int cin, int cout, int epilogue, void* stream) {
  using namespace gather_gemm;
  if (m == 0) return (int)cudaSuccess;
  if (!shapes_ok(m, n, k, cin, cout) || epilogue < 0 || epilogue > 2)
    return (int)cudaErrorInvalidValue;
  const auto* f = (const float*)feats;
  const auto* wf = (const float*)w;
  const auto* nb = (const int*)nbr;
  const auto* od = (const int*)order;
  const auto* sc = (const float*)scale;
  const auto* sh = (const float*)shift;
  auto* o = (float*)out;
  const auto s = (cudaStream_t)stream;
  switch (epilogue) {
    case 0: return (int)launch<0>(f, wf, nb, od, sc, sh, o, m, n, k, cin, cout, s);
    case 1: return (int)launch<1>(f, wf, nb, od, sc, sh, o, m, n, k, cin, cout, s);
    default: return (int)launch<2>(f, wf, nb, od, sc, sh, o, m, n, k, cin, cout, s);
  }
}
