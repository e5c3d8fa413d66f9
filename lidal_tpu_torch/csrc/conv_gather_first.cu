// Gather-first sparse convolution on bf16 operands, from a bf16 table or from
// two int8 byte planes: the bf16 route's conv and the probes' convs.
//
// On the bf16 route (ops/conv.BF16_OPERANDS, the counterpart of
// lidal_tpu/ops/conv.py:USE_PALLAS) it takes the place of
// lidal_tpu/ops/pallas_conv.py:subm_conv_pallas: every forward conv of
// MinkUNet and SPVCNN, submanifold (K = 27), down and up (K = 8), with the
// eval BatchNorm epilogue in inference.  It also replaces
// tools/probe_conv_v3.py:subm_conv_v3 (the bf16 table, with and without
// `pipelined`) and tools/probe_int8_gather.py:subm_conv_i8 (the byte
// planes).  It computes
//
//   out[i] = sum_k feats[nbr[i, k]] @ w[k]      (f32 sums; an index outside [0, n) gives 0)
//
// on operands rounded to bf16, and with the epilogue (bf16 table only) y =
// out * scale + shift, relu if asked, 0 on rows with no real tap.  The TPU
// kernels gather with one-hot matmuls over banded DMA blocks and pad channels
// to 128 lanes; none of that carries over.  subm_conv_pallas also rounds each
// tap's folded product feats @ w[k] to bf16 before the f32 sum over taps; this
// kernel keeps the whole sum in f32, so it is closer to f64 than the TPU
// kernel and agrees with it to 2**-8 of the abs-sum, not bit for bit.
// Here the gathered rows of a 128- or 192-row tile are assembled in shared
// memory first, straight into the layout the tensor cores read, and
// contracted by wgmma: the bf16 gather-GEMM tile of gather_gemm_bf16.cuh (its
// header says how, and what bounds it: L2's bandwidth for the gathered pieces
// and the weights).  Products of bf16 values are exact in f32, so the result
// differs from the plain version only by the order of the f32 sums.
//
// * `pipelined` picks the depth of the tile's ring of stages: 4 without, the
//   deepest that fits an SM's shared memory (at most 8) with.  The arithmetic
//   and its order are the same, so the outputs are bit-equal; the deeper ring
//   measured no faster, since more bytes in flight do not raise L2's rate.
// * The byte planes (row i: cin low bytes, then cin high bytes of the bf16 bit
//   patterns) are rebuilt into the bf16 bits on the way into shared memory,
//   (hi & 0xFF) << 8 | (lo & 0xFF): a lossless re-encoding, bit-equal to the
//   bf16 table.  On the TPU the planes let the one-hot product run at the int8
//   rate; here there is no such product, and what the variant measures is two
//   1-byte-plane row reads, through registers, against one 2-byte row read by
//   cp.async.

#include "gather_gemm_bf16.cuh"

// table: bf16 [n, cin] (planes == 0) or int8 [n, 2 * cin], low-byte plane then
// high-byte plane (planes == 1); wt: bf16 [k, cout, cin], the weights with the
// input channels contiguous; nbr: int32 [m, k]; scale, shift: f32 [cout], read
// only when epilogue > 0; out: f32 [m, cout].  All contiguous on the current
// device, table and wt 16-byte aligned.  epilogue: 0 none, 1 affine, 2 affine
// + relu (bf16 table only).  bn, rows: the tile (32, 64, 96 or 128 columns
// dividing cout; 128 rows, or 192 at bn >= 96); stages: the ring's depth (3 ..
// 8, within an SM's shared memory).  Needs k <= 27 and cin % 16 == 0.
// Returns the first CUDA error of the launch.
extern "C" int lidal_conv_gather_first(const void* table, const void* wt, const void* nbr, const void* scale,
                                       const void* shift, void* out, int m, int n, int k, int cin, int cout,
                                       int planes, int epilogue, int bn, int rows, int stages, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (cin % 16 != 0 || !gather_gemm_bf16::shapes_ok(m, n, k, cin, cout, bn, rows, stages) || epilogue < 0 ||
      epilogue > 2 || (planes && epilogue) || (epilogue && (scale == nullptr || shift == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto* np = (const int*)nbr;
  const auto* sc = (const float*)scale;
  const auto* sh = (const float*)shift;
  auto* op = (float*)out;
  using gather_gemm_bf16::launch;
  if (planes) return (int)launch<true, 0>(table, wt, np, sc, sh, op, m, n, k, cin, cout, bn, rows, stages, s);
  switch (epilogue) {
    case 0: return (int)launch<false, 0>(table, wt, np, sc, sh, op, m, n, k, cin, cout, bn, rows, stages, s);
    case 1: return (int)launch<false, 1>(table, wt, np, sc, sh, op, m, n, k, cin, cout, bn, rows, stages, s);
    default: return (int)launch<false, 2>(table, wt, np, sc, sh, op, m, n, k, cin, cout, bn, rows, stages, s);
  }
}
