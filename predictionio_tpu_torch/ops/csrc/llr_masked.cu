// Fused LLR scoring + masking for CCO training, hand-written for Hopper (sm_90a).
//
//   k11 = c, k12 = row - c, k21 = col - c, k22 = n - k11 - k12 - k21
//   out = G2(k11, k12, k21, k22)        Dunning's G2 in determinant form
//   out = -inf                          where c == 0 or G2 < threshold
//
// Replaces the TPU kernel `_llr_kernel` / `_llr_padded` in
// predictionio_tpu/ops/pallas_kernels.py (pl.pallas_call at line 191), the
// LLR pass of every CCO strategy (`_llr_mask_scores`, ops/cco.py).
//
// What bounds it on an H100: memory, once zero counts cost nothing.  Per cell
// it reads one count and writes one score (8 bytes); a nonzero cell adds four
// IEEE divisions and four accurate log1pf (228 SASS instructions on sm_90a).
// At the 100k-item training tile [100,000 x 4,096] the bytes take ~0.98 ms at
// 3.35 TB/s, and over 99% of the training counts are zero.
//
// Design:
//   - 16-byte accesses: each thread reads four counts as one int4 and writes
//     four scores as one float4, four such accesses in flight, so a block
//     step covers 4,096 columns of one row.  Blocks walk (row, 4,096-column)
//     units in a grid-stride loop, not one block per (row, 1,024 columns).
//     A row need not start 16-byte aligned (a row-strided view of a padded
//     product, or C no multiple of 4): each row's column grid is shifted to
//     its counts' alignment, a lane whose four columns cross the row's ends
//     reads them one by one, and a score row aligned otherwise than its
//     counts is written 4 bytes at a time.
//   - Zero counts skip the arithmetic: a zero count is -inf whatever G2
//     would be.  A warp whose lanes hold no nonzero count in an access
//     (__any_sync) writes -inf without computing.  A warp that has one
//     compacts its nonzero cells (__ballot_sync/__popc) into shared memory
//     and shares them out over its lanes, so the arithmetic runs once per 32
//     nonzero cells and no lane idles on a zero count.
//   - The grid is one wave of resident blocks (the occupancy calculator's
//     count times the SMs), so the grid-stride loop splits the units evenly.
//   - The count product's int32 output is read directly (the Pallas wrapper
//     first pads and casts it to f32, an extra pass over the tile).
//
// Numerics: the f32 expression order of the reference (`llr_score`,
// `_llr_term`, ops/cco.py) is kept term by term, with explicit
// round-to-nearest intrinsics so nvcc never contracts a product and a sum
// into one FMA (the determinant k11*k22 - k12*k21 cancels, and an FMA there
// would round differently from the reference).  The clamp `-1 + 1e-9` of
// the reference rounds to exactly -1.0f in f32, so it is -1.0f here.  Build
// without --use_fast_math, so log1pf and the division stay IEEE.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kVec = 4;                                // cells a 16-byte access
constexpr int kUnroll = 4;                             // accesses in flight a thread
constexpr int kUnitCols = kThreads * kVec * kUnroll;   // 4,096 columns a block step

// k * log1p(sign * d / max(rm * cm, 1e-30)), or 0 where k == 0
__device__ __forceinline__ float llr_term(float k, float sd, float rm, float cm) {
  const float arg = __fdiv_rn(sd, fmaxf(__fmul_rn(rm, cm), 1e-30f));
  return k > 0.f ? __fmul_rn(k, log1pf(fmaxf(arg, -1.0f))) : 0.f;
}

// The masked score of one cell with a nonzero count: G2, -inf below the
// threshold.
__device__ __forceinline__ float llr_nonzero(int32_t count, float rm, float cm,
                                             float n_total, float threshold) {
  const float k11 = __int2float_rn(count);
  const float k12 = __fsub_rn(rm, k11);
  const float k21 = __fsub_rn(cm, k11);
  const float k22 = __fsub_rn(__fsub_rn(__fsub_rn(n_total, k11), k12), k21);
  const float r1 = __fadd_rn(k11, k12), r2 = __fadd_rn(k21, k22);
  const float c1 = __fadd_rn(k11, k21), c2 = __fadd_rn(k12, k22);
  const float d = __fsub_rn(__fmul_rn(k11, k22), __fmul_rn(k12, k21));
  float g2 = __fadd_rn(__fadd_rn(__fadd_rn(llr_term(k11, d, r1, c1),
                                           llr_term(k12, -d, r1, c2)),
                                 llr_term(k21, -d, r2, c1)),
                       llr_term(k22, d, r2, c2));
  g2 = fmaxf(__fmul_rn(2.0f, g2), 0.f);
  return g2 >= threshold ? g2 : -CUDART_INF_F;
}

// A warp's scratch for one access of 32 x 4 cells
struct WarpCells {
  int32_t count[32 * kVec];   // the nonzero cells, compacted
  int32_t col[32 * kVec];
  int32_t slot[32 * kVec];    // lane * 4 + i of each
  float4 score[32];           // by lane
};

// The masked scores o[i] of four cells a lane (counts k[i] at columns
// col[i] of one row), the warp's 128 cells together.  A zero count is -inf
// with no arithmetic.  When the warp has a nonzero count, its nonzero cells
// are compacted (__ballot_sync/__popc) and the lanes share them out, so the
// arithmetic runs once per 32 nonzero cells, not once per slot with the
// zero lanes idle.
__device__ __forceinline__ void warp_cells(const int32_t (&k)[kVec], const int (&col)[kVec],
                                           float (&o)[kVec], float rm,
                                           const float* __restrict__ col_marg,
                                           float n_total, float threshold,
                                           WarpCells& w, int lane) {
  const float neg_inf = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < kVec; ++i) o[i] = neg_inf;
  if (!__any_sync(kFull, k[0] > 0 || k[1] > 0 || k[2] > 0 || k[3] > 0)) return;   // warp-uniform
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const unsigned m = __ballot_sync(kFull, k[i] > 0);
    if (k[i] > 0) {
      const int at = n + __popc(m & below);
      w.count[at] = k[i];
      w.col[at] = col[i];
      w.slot[at] = lane * kVec + i;
    }
    n += __popc(m);
  }
  __syncwarp();
  float* score = reinterpret_cast<float*>(w.score);
  for (int q = lane; q < n; q += 32) {
    score[w.slot[q]] = llr_nonzero(w.count[q], rm, col_marg[w.col[q]], n_total, threshold);
  }
  __syncwarp();
  const float4 mine = w.score[lane];
  if (k[0] > 0) o[0] = mine.x;
  if (k[1] > 0) o[1] = mine.y;
  if (k[2] > 0) o[2] = mine.z;
  if (k[3] > 0) o[3] = mine.w;
  __syncwarp();   // before the next access reuses w
}

__global__ void __launch_bounds__(kThreads)
llr_masked_kernel(const int32_t* __restrict__ counts, long long ld,
                  const float* __restrict__ row_marg,
                  const float* __restrict__ col_marg, float n_total,
                  float threshold, float* __restrict__ out, int C,
                  long long units, int units_per_row) {
  __shared__ WarpCells scratch[kThreads / 32];
  const int lane = threadIdx.x & 31;
  WarpCells& w = scratch[threadIdx.x >> 5];
  for (long long unit = blockIdx.x; unit < units; unit += gridDim.x) {   // block-uniform
    const int row = static_cast<int>(unit / units_per_row);
    const int j = static_cast<int>(unit % units_per_row);
    const float rm = row_marg[row];
    const int32_t* crow = counts + static_cast<long long>(row) * ld;
    float* orow = out + static_cast<long long>(row) * C;
    // The row's column grid starts at -mis, so that a lane's four columns
    // are one aligned int4 of counts wherever they all lie inside the row;
    // the scores take one float4 where their row is aligned alike.  Unit j
    // covers grid columns [4096 j, 4096 (j + 1)), the row's last unit the
    // rest of the row too (up to 4,095 + mis more columns, in a second step).
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(crow) >> 2) & 3);
    const bool out_vec = static_cast<int>((reinterpret_cast<uintptr_t>(orow) >> 2) & 3) == mis;
    const int begin = j * kUnitCols - mis;
    const int end = j == units_per_row - 1 ? C : begin + kUnitCols;
    for (int c0 = begin; c0 < end; c0 += kUnitCols) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + (u * kThreads + threadIdx.x) * kVec;
        if (c >= 0 && c + 3 < C) {
          v[u] = *reinterpret_cast<const int4*>(crow + c);
        } else {   // the ragged head and tail: lane by lane, zero outside the row
          v[u].x = c >= 0 && c < C ? crow[c] : 0;
          v[u].y = c + 1 >= 0 && c + 1 < C ? crow[c + 1] : 0;
          v[u].z = c + 2 >= 0 && c + 2 < C ? crow[c + 2] : 0;
          v[u].w = c + 3 >= 0 && c + 3 < C ? crow[c + 3] : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + (u * kThreads + threadIdx.x) * kVec;
        const int32_t k[kVec] = {v[u].x, v[u].y, v[u].z, v[u].w};
        const int col[kVec] = {c, c + 1, c + 2, c + 3};
        float o[kVec];
        warp_cells(k, col, o, rm, col_marg, n_total, threshold, w, lane);
        if (out_vec && c >= 0 && c + 3 < C) {
          *reinterpret_cast<float4*>(orow + c) = make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            if (c + i >= 0 && c + i < C) orow[c + i] = o[i];
          }
        }
      }
    }
  }
}

int resident_blocks() {
  static int n = 0;
  if (n == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, llr_masked_kernel, kThreads, 0);
    if (n <= 0) n = 1;
  }
  return n;
}

}  // namespace

// C ABI for ctypes.  counts: [R, C] int32 with row stride `ld` elements;
// row_marg: [R] f32; col_marg: [C] f32; out: [R, C] f32 contiguous.  Rows
// need no alignment.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = launched).
extern "C" int pio_llr_masked(const void* counts, long long ld,
                              const void* row_marg, const void* col_marg,
                              float n_total, float threshold, void* out,
                              int R, int C, void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  // every unit but a row's last covers 4,096 columns; the last, the rest of
  // the row (at most 8,194)
  const int units_per_row = C / kUnitCols > 1 ? C / kUnitCols : 1;
  const long long units = static_cast<long long>(R) * units_per_row;
  // one wave of resident blocks: the grid-stride loop splits the units evenly
  const long long cap = static_cast<long long>(sms) * resident_blocks();
  const int grid = static_cast<int>(units < cap ? units : cap);
  llr_masked_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), ld, static_cast<const float*>(row_marg),
      static_cast<const float*>(col_marg), n_total, threshold, static_cast<float*>(out), C,
      units, units_per_row);
  return static_cast<int>(cudaGetLastError());
}
