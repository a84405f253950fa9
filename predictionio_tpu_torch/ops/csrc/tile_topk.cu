// Exact per-row top-b of a score tile, hand-written for Hopper (sm_90a).
//
//   out_s[r, :b], out_i[r, :b] = the b largest scores of row r and their
//   column ids (+ id_offset), in (score desc, column asc) order
//
// Replaces the TPU kernel `_topk_sort_kernel` / `_tile_topk_padded` (with
// `_tournament_topb` and `_roll_stage`) in predictionio_tpu/ops/
// pallas_kernels.py (pl.pallas_call at line 321): the per-tile top-k of the
// tiled CCO merge and the row top-k of the dense CCO path.
//
// Order.  Every entry is ranked by one 64-bit key: the score's monotone
// image in the high word and the complement of its column in the low word.
// All keys are distinct, so the result is exactly `lax.top_k`'s (ties to
// the lower column, -0.0 below +0.0), which is stricter than the Pallas
// kernel's "values exact, ties may reorder".  Columns past the row's end
// are padding with the key of (-inf, column): they rank below every real
// entry, -inf included, and surface only when the row is narrower than b.
//
// What bounds it on an H100: compare-exchanges, not bytes.  A row of W
// scores is read once (4W bytes) and the network does ~17 W compare-
// exchanges of 64-bit keys in shared memory for b = 64; at the 100k-item
// training tile [100,000 x 4,096] the bytes alone would take ~0.5 ms.
//
// Design: one block of 256 threads per row.  The row streams through
// shared memory in chunks of at most 4,096 keys (32 KB, so no opt-in above
// 48 KB is needed and several blocks share an SM); a row is never padded in
// device memory, however wide.  Per chunk:
//   1. bitonic-sort every b-wide block, directions alternating (desc, asc);
//   2. tournament rounds: each adjacent (desc, asc) pair is bitonic, so the
//      elementwise max of its halves is exactly its top-b (the half-cleaner
//      theorem), and log2(b) stages restore alternating order.  The
//      surviving blocks stay in place at a doubling stride;
//   3. merge the chunk's top-b with the row's running top-b (a bitonic
//      half-cleaner against the reversed chunk list, then log2(b) stages).
// This is the Pallas kernel's tournament, done in shared memory with
// __syncthreads between stages.  Faster variants (warp-shuffle stages in
// registers, a threshold pre-filter) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t make_key(float s, uint32_t col) {
  const int32_t bits = __float_as_int(s);
  const int32_t mono = bits ^ ((bits >> 31) & 0x7FFFFFFF);   // monotone in s
  const uint32_t hi = static_cast<uint32_t>(mono) ^ 0x80000000u;  // as unsigned
  return (static_cast<uint64_t>(hi) << 32) | static_cast<uint64_t>(0xFFFFFFFFu - col);
}

__device__ __forceinline__ float key_score(uint64_t key) {
  const int32_t mono = static_cast<int32_t>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u);
  return __int_as_float(mono ^ ((mono >> 31) & 0x7FFFFFFF));   // the map is an involution
}

__device__ __forceinline__ uint32_t key_col(uint64_t key) {
  return 0xFFFFFFFFu - static_cast<uint32_t>(key & 0xFFFFFFFFull);
}

// order keys[lo] and keys[hi]: the larger first when desc
__device__ __forceinline__ void cmpex(uint64_t* keys, int lo, int hi, bool desc) {
  const uint64_t a = keys[lo], b = keys[hi];
  if ((a < b) == desc) {
    keys[lo] = b;
    keys[hi] = a;
  }
}

__global__ void __launch_bounds__(kThreads)
tile_topk_kernel(const float* __restrict__ scores, long long ld, int W, int b,
                 int chunk, int id_offset, float* __restrict__ out_s,
                 int32_t* __restrict__ out_i) {
  extern __shared__ uint64_t smem[];
  uint64_t* keys = smem;           // [chunk]
  uint64_t* run = smem + chunk;    // [b], the row's running top-b, desc
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int lb = __ffs(b) - 1;     // b is a power of two: e / b == e >> lb
  const float* srow = scores + (long long)row * ld;

  for (int t = tid; t < b; t += kThreads) run[t] = 0ull;   // below every key

  for (int c0 = 0; c0 < W; c0 += chunk) {
    for (int i = tid; i < chunk; i += kThreads) {
      const int j = c0 + i;
      keys[i] = make_key(j < W ? srow[j] : -__int_as_float(0x7f800000), static_cast<uint32_t>(j));
    }
    __syncthreads();

    // 1. bitonic sort of each b-block; block q ends desc when q is even
    for (int k = 2; k <= b; k <<= 1) {
      for (int d = k >> 1; d > 0; d >>= 1) {
        for (int e = tid; e < (chunk >> 1); e += kThreads) {
          const int lo = ((e & ~(d - 1)) << 1) | (e & (d - 1));
          cmpex(keys, lo, lo + d, (lo & k) == 0);
        }
        __syncthreads();
      }
    }

    // 2. tournament: logical block g lives at physical block g << r
    int r = 0;
    for (int w = chunk; w > b; w >>= 1, ++r) {
      const int pairs = w / (2 * b);
      for (int e = tid; e < pairs * b; e += kThreads) {
        const int g = e >> lb, t = e & (b - 1);
        const int lo = ((2 * g) << r) * b + t, hi = ((2 * g + 1) << r) * b + t;
        if (keys[hi] > keys[lo]) keys[lo] = keys[hi];
      }
      __syncthreads();
      const int half = b >> 1;
      for (int d = half; d > 0; d >>= 1) {
        for (int e = tid; e < pairs * half; e += kThreads) {
          const int g = e >> (lb - 1), within = e & (half - 1);
          const int t = ((within & ~(d - 1)) << 1) | (within & (d - 1));
          const int base = (g << (r + 1)) * b;
          cmpex(keys, base + t, base + t + d, (g & 1) == 0);
        }
        __syncthreads();
      }
    }

    // 3. merge the chunk's top-b (keys[0, b), desc) into the running top-b
    for (int t = tid; t < b; t += kThreads) {
      const uint64_t other = keys[b - 1 - t];
      if (other > run[t]) run[t] = other;
    }
    __syncthreads();
    for (int d = b >> 1; d > 0; d >>= 1) {
      for (int e = tid; e < (b >> 1); e += kThreads) {
        const int lo = ((e & ~(d - 1)) << 1) | (e & (d - 1));
        cmpex(run, lo, lo + d, true);
      }
      __syncthreads();
    }
  }

  for (int t = tid; t < b; t += kThreads) {
    const uint64_t key = run[t];
    out_s[(long long)row * b + t] = key_score(key);
    out_i[(long long)row * b + t] = static_cast<int32_t>(key_col(key)) + id_offset;
  }
}

}  // namespace

// C ABI for ctypes.  scores: [R, W] f32 with row stride `ld` elements; b a
// power of two in [1, 1024]; out_s: [R, b] f32 and out_i: [R, b] int32, both
// contiguous.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = launched).
extern "C" int pio_tile_topk(const void* scores, long long ld, int R, int W, int b,
                             int id_offset, void* out_s, void* out_i, void* stream) {
  int chunk = 2 * b;   // a power of two, at least 2b, at most max(4,096, 2b) keys
  while (chunk < W && chunk < 4096) chunk <<= 1;
  if (chunk < 2 * b) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(chunk + b) * sizeof(uint64_t);
  tile_topk_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), ld, W, b, chunk, id_offset,
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
