// Fused LLR scoring + masking for CCO training, hand-written for Hopper (sm_90a).
//
//   k11 = c, k12 = row - c, k21 = col - c, k22 = n - k11 - k12 - k21
//   out = G2(k11, k12, k21, k22)        Dunning's G2 in determinant form
//   out = -inf                          where c == 0 or G2 < threshold
//
// Replaces the TPU kernel `_llr_kernel` / `_llr_padded` in
// predictionio_tpu/ops/pallas_kernels.py (pl.pallas_call at line 191), the
// LLR pass of every CCO strategy (`_llr_mask_scores`, ops/cco.py:185).
//
// What bounds it on an H100: memory.  Per cell it reads one count and writes
// one score (8 bytes) for ~40 fp32 operations and four log1pf: ~5
// operations per byte, far below the ~20 at which fp32 arithmetic would be
// the limit.  At the 100k-item training tile [100,000 x 4,096] that is
// 3.3 GB, ~0.98 ms at 3.35 TB/s.
//
// The design follows from that: one pass, nothing padded.  The count
// product's int32 output is read directly (the Pallas wrapper first pads
// and casts it to f32, an extra pass over the tile).  A block owns one row
// and 1,024 columns; it reads the row marginal once, and consecutive
// threads touch consecutive columns, so loads and stores are coalesced.
// The ragged column edge is masked by the kernel.
//
// Numerics: the f32 expression order of the reference (`llr_score`,
// `_llr_term`, ops/cco.py:273-299) is kept term by term, with explicit
// round-to-nearest intrinsics so nvcc never contracts a product and a sum
// into one FMA (the determinant k11*k22 - k12*k21 cancels, and an FMA there
// would round differently from the reference).  The clamp `-1 + 1e-9` of
// the reference rounds to exactly -1.0f in f32, so it is -1.0f here.  Build
// without --use_fast_math, so log1pf and the division stay IEEE.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kCols = kThreads * kPerThread;   // columns per block

// k * log1p(sign * d / max(rm * cm, 1e-30)), or 0 where k == 0
__device__ __forceinline__ float llr_term(float k, float sd, float rm, float cm) {
  const float arg = __fdiv_rn(sd, fmaxf(__fmul_rn(rm, cm), 1e-30f));
  return k > 0.f ? __fmul_rn(k, log1pf(fmaxf(arg, -1.0f))) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
llr_masked_kernel(const int32_t* __restrict__ counts, long long ld,
                  const float* __restrict__ row_marg,
                  const float* __restrict__ col_marg, float n_total,
                  float threshold, float* __restrict__ out, int R, int C) {
  const int row = blockIdx.x;
  const int c0 = blockIdx.y * kCols + threadIdx.x;
  const float rm = row_marg[row];
  const int32_t* crow = counts + (long long)row * ld;
  float* orow = out + (long long)row * C;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int j = c0 + u * kThreads;
    if (j >= C) break;
    const float k11 = __int2float_rn(crow[j]);
    const float k12 = __fsub_rn(rm, k11);
    const float k21 = __fsub_rn(col_marg[j], k11);
    const float k22 = __fsub_rn(__fsub_rn(__fsub_rn(n_total, k11), k12), k21);
    const float r1 = __fadd_rn(k11, k12), r2 = __fadd_rn(k21, k22);
    const float c1 = __fadd_rn(k11, k21), c2 = __fadd_rn(k12, k22);
    const float d = __fsub_rn(__fmul_rn(k11, k22), __fmul_rn(k12, k21));
    float g2 = __fadd_rn(__fadd_rn(__fadd_rn(llr_term(k11, d, r1, c1),
                                             llr_term(k12, -d, r1, c2)),
                                   llr_term(k21, -d, r2, c1)),
                         llr_term(k22, d, r2, c2));
    g2 = fmaxf(__fmul_rn(2.0f, g2), 0.f);
    orow[j] = (k11 > 0.f && g2 >= threshold) ? g2 : -CUDART_INF_F;
  }
}

}  // namespace

// C ABI for ctypes.  counts: [R, C] int32 with row stride `ld` elements;
// row_marg: [R] f32; col_marg: [C] f32; out: [R, C] f32 contiguous.
// Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = launched).
extern "C" int pio_llr_masked(const void* counts, long long ld,
                              const void* row_marg, const void* col_marg,
                              float n_total, float threshold, void* out,
                              int R, int C, void* stream) {
  const dim3 grid(R, (C + kCols - 1) / kCols);
  llr_masked_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), ld, static_cast<const float*>(row_marg),
      static_cast<const float*>(col_marg), n_total, threshold,
      static_cast<float*>(out), R, C);
  return static_cast<int>(cudaGetLastError());
}
