// Fused masked score product for ALS serving, hand-written for Hopper (sm_90a).
//
//   out[b, i] = dot(U[b, :], V[i, :]) + bias[i]      (fp32, fp32 accumulation)
//   out[b, i] = -inf                                  where mask[b, i] > 0
//
// Replaces the TPU kernel `_score_kernel` / `_masked_score_matmul` in
// predictionio_tpu/ops/pallas_kernels.py (pl.pallas_call at line 105).  As
// there, the bias add and the mask are applied to the product tile while it
// is still in registers, so the [B, I] score matrix is written to device
// memory once and never read back.
//
// What bounds it on an H100: memory.  Serving calls it with B = 1 (one query)
// or B <= 64 (one serving micro-batch) against a catalog of I ~ 1e5 items at
// rank K = 32: one launch reads V (I*K*4 bytes) and the mask (B*I bytes as
// uint8), and writes B*I*4 bytes of scores, for 2*B*I*K operations.  At
// B = 1 that is ~0.06 operations per byte; even at B = 256, K = 64 the fp32
// work (3.3 GFLOP, ~49 us at 67 TFLOP/s) only ties the bytes (~154 MB,
// ~46 us at 3.35 TB/s).  The tensor cores are not needed: their fp32 path is
// TF32, which would break the 1e-5 parity with the JAX reference.
//
// The design follows from that: a plain register-blocked fp32 product.
// Each block of 16x16 threads owns a tile of TILE_B rows x 64 items; per
// K-chunk of 16 it stages the V and U slices in shared memory (neighbouring
// threads read neighbouring addresses of V's rows) and each thread
// accumulates RPT x 4 outputs in registers.  Items a thread owns are 16 apart,
// so a warp's stores of one output row are contiguous.  Rows per thread
// (RPT) is 1 for B <= 16, so a single query does not run 64 idle rows, and 4
// above that, so each V tile is reused across 64 rows.  Ragged B, I and K
// edges are masked by the kernel itself (loads outside read as 0, stores
// outside are skipped): nothing is padded by the caller.  Making it fast
// (cp.async/TMA double buffering, wider loads, a fused per-row top-k) is
// later work; this first version is simple and exact.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTX = 16;            // threads along items
constexpr int kTY = 16;            // threads along rows
constexpr int kIPT = 4;            // items per thread
constexpr int kTileI = kTX * kIPT; // 64 items per block
constexpr int kTileK = 16;         // K-chunk staged per step

__device__ __forceinline__ bool masked(uint8_t m) { return m != 0; }
__device__ __forceinline__ bool masked(float m) { return m > 0.f; }

template <int RPT, typename MaskT>
__global__ void __launch_bounds__(kTX * kTY)
masked_score_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    const MaskT* __restrict__ mask, long long mask_ld,
                    const float* __restrict__ bias, int has_bias,
                    float* __restrict__ out, int B, int I, int K) {
  constexpr int kTileB = kTY * RPT;
  // +1 column: the transposed stores below hit fewer shared-memory banks
  __shared__ float us[kTileK][kTileB + 1];
  __shared__ float vs[kTileK][kTileI + 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int i0 = blockIdx.x * kTileI;
  const int b0 = blockIdx.y * kTileB;

  float acc[RPT][kIPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < kIPT; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    // consecutive threads read consecutive k of one row: coalesced
    for (int e = tid; e < kTileI * kTileK; e += kTX * kTY) {
      const int ii = e / kTileK, kk = e % kTileK;
      const int i = i0 + ii, k = k0 + kk;
      vs[kk][ii] = (i < I && k < K) ? v[(long long)i * K + k] : 0.f;
    }
    for (int e = tid; e < kTileB * kTileK; e += kTX * kTY) {
      const int bb = e / kTileK, kk = e % kTileK;
      const int b = b0 + bb, k = k0 + kk;
      us[kk][bb] = (b < B && k < K) ? u[(long long)b * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[RPT], w[kIPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) a[r] = us[kk][ty + kTY * r];
#pragma unroll
      for (int j = 0; j < kIPT; ++j) w[j] = vs[kk][tx + kTX * j];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < kIPT; ++j) acc[r][j] = fmaf(a[r], w[j], acc[r][j]);
    }
    __syncthreads();
  }

  // epilogue: bias and mask on the tile in registers, one store per score
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int b = b0 + ty + kTY * r;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < kIPT; ++j) {
      const int i = i0 + tx + kTX * j;
      if (i >= I) continue;
      float s = acc[r][j];
      if (has_bias) s += bias[i];
      if (masked(mask[(long long)b * mask_ld + i])) s = -CUDART_INF_F;
      out[(long long)b * I + i] = s;
    }
  }
}

template <typename MaskT>
void launch(const float* u, const float* v, const MaskT* mask, long long mask_ld,
            const float* bias, int has_bias, float* out, int B, int I, int K,
            cudaStream_t stream) {
  const dim3 block(kTX, kTY);
  if (B <= kTY) {
    const dim3 grid((I + kTileI - 1) / kTileI, (B + kTY - 1) / kTY);
    masked_score_kernel<1, MaskT><<<grid, block, 0, stream>>>(
        u, v, mask, mask_ld, bias, has_bias, out, B, I, K);
  } else {
    constexpr int kTileB = kTY * 4;
    const dim3 grid((I + kTileI - 1) / kTileI, (B + kTileB - 1) / kTileB);
    masked_score_kernel<4, MaskT><<<grid, block, 0, stream>>>(
        u, v, mask, mask_ld, bias, has_bias, out, B, I, K);
  }
}

}  // namespace

// C ABI for ctypes.  u: [B, K] f32, v: [I, K] f32, both contiguous; mask:
// [B, I] with row stride mask_ld elements, uint8 (mask_is_f32 = 0) or f32
// (mask_is_f32 = 1); bias: [I] f32, read only when has_bias != 0; out:
// [B, I] f32 contiguous.  Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 = launched).
extern "C" int pio_masked_score(const void* u, const void* v, const void* mask,
                                int mask_is_f32, long long mask_ld,
                                const void* bias, int has_bias, void* out,
                                int B, int I, int K, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask_is_f32) {
    launch<float>(static_cast<const float*>(u), static_cast<const float*>(v),
                  static_cast<const float*>(mask), mask_ld,
                  static_cast<const float*>(bias), has_bias,
                  static_cast<float*>(out), B, I, K, s);
  } else {
    launch<uint8_t>(static_cast<const float*>(u), static_cast<const float*>(v),
                    static_cast<const uint8_t*>(mask), mask_ld,
                    static_cast<const float*>(bias), has_bias,
                    static_cast<float*>(out), B, I, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}
