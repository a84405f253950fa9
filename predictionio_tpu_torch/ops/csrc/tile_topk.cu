// Exact per-row top-b of a score tile, hand-written for Hopper (sm_90a),
// optionally merged with a running carry in the same pass.
//
//   out_s[r, :b], out_i[r, :b] = the b largest scores of row r and their
//   column ids (+ id_offset), in (score desc, column asc) order
//
// With a carry (carry_s, carry_i, each [R, b]) the result is instead the top-b
// of [carry, tile] ranked as ops/topk.py:merge_desc ranks them: equal scores
// keep carry entries first (in carry order), then tile columns ascending; a
// carry entry's id is read back from carry_i.  That is exactly
// merge_desc(carry, tile_topk(scores)), the carry merge of the tiled CCO loop,
// without a second pass.
//
// Replaces the TPU kernel `_topk_sort_kernel` / `_tile_topk_padded` (with
// `_tournament_topb` and `_roll_stage`) in predictionio_tpu/ops/
// pallas_kernels.py (pl.pallas_call at line 321), and the carry merge
// `merge_desc` (predictionio_tpu/ops/topk.py:139) that follows it in the tiled
// CCO strategy.
//
// Order.  Every entry is ranked by one 64-bit key: the score's monotone image
// in the high word and the complement of a position in the low word.  A carry
// entry's position is its carry slot p < b; a tile column c has position
// b + c.  All keys are distinct, so the result is exactly `lax.top_k`'s (ties
// to the lower column, -0.0 below +0.0).  Columns past the row's end, up to
// b, are padding with the key of (-inf, column): they rank below every real
// entry, -inf included, and surface only when the row is narrower than b.
//
// What bounds it on an H100: bytes, once the work tracks the data.  A row of
// W scores is read once (4W bytes); at the 100k-item training tile
// [100,000 x 4,096] that alone takes ~0.5 ms.
//
// Design: one warp per row, several rows a block, no block-wide barrier.
//   - The row streams through registers in coalesced 16-byte loads, four in
//     flight a lane (512 columns a warp step), on a column grid aligned to
//     16 bytes; a lane whose four columns cross the row's ends reads them
//     one by one.
//   - The running top-N (N = max(b, 32)) lives in registers, N/32 keys a
//     lane, sorted descending across (lane, slot).  Its smallest key is the
//     warp's threshold.
//   - Pre-filter: only keys above the threshold are kept, compacted into a
//     per-warp shared-memory buffer with __ballot_sync/__popc.  A key at or
//     below the threshold cannot reach the top-N.  After a step in which the
//     buffer reached N keys (and at the row's end) the warp sorts them N at a
//     time with a bitonic network in registers (__shfl_xor_sync across
//     lanes, compare-exchanges within a lane), merges each N into the running
//     top-N (elementwise max against the reversed list, then log2(N) cleanup
//     stages) and raises the threshold.
//   - The carry is offered first, so for b >= 32 the threshold starts at the
//     carry's b-th key: on the training tiles (>99% of scores -inf, which
//     rank below the (-inf, slot) initial carry) almost only the finite
//     scores pass.  Without a carry the first step's 128 keys all pass; on
//     random rows about N(1 + ln(W/N)) keys pass in all.  An ascending
//     row passes every key: slow, still exact.
//   - Registers: 64 a thread at b = 64 (eight rows a block); b = 1024 holds
//     32 keys a lane twice over and takes 254.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;                   // 16-byte loads in flight a lane
constexpr int kStep = 32 * 4 * kUnroll;      // columns a warp step: 512
constexpr int kMaxWarps = 8;                 // rows a block
constexpr int kSmemBudget = 48 * 1024;       // no opt-in above 48 KB

__device__ __forceinline__ u64 make_key(float s, uint32_t pos) {
  const int32_t bits = __float_as_int(s);
  const int32_t mono = bits ^ ((bits >> 31) & 0x7FFFFFFF);      // monotone in s
  const uint32_t hi = static_cast<uint32_t>(mono) ^ 0x80000000u;  // as unsigned
  return (static_cast<u64>(hi) << 32) | static_cast<u64>(0xFFFFFFFFu - pos);
}

__device__ __forceinline__ float key_score(u64 key) {
  const int32_t mono = static_cast<int32_t>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u);
  return __int_as_float(mono ^ ((mono >> 31) & 0x7FFFFFFF));   // the map is an involution
}

__device__ __forceinline__ uint32_t key_pos(u64 key) {
  return 0xFFFFFFFFu - static_cast<uint32_t>(key & 0xFFFFFFFFull);
}

// One bitonic stage over the warp's N = 32 E keys, element e = lane * E + j
// held in x[j] of lane `lane`: e and e ^ d are ordered, the larger first where
// (e & k) == 0.  Distances below E stay inside a lane; larger ones pair
// lane with lane ^ (d / E), and each side keeps its own half.
template <int E>
__device__ __forceinline__ void bitonic_stage(u64 (&x)[E], int lane, int k, int d) {
  if (d < E) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if ((j & d) == 0) {
        const bool desc = ((lane * E + j) & k) == 0;
        const u64 a = x[j], b = x[j + d];
        const bool swap = (a < b) == desc;
        x[j] = swap ? b : a;
        x[j + d] = swap ? a : b;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = lane * E + j;
      const bool keep_max = (((e & d) == 0) == ((e & k) == 0));
      const u64 y = __shfl_xor_sync(kFull, x[j], d / E);
      x[j] = keep_max ? (x[j] > y ? x[j] : y) : (x[j] < y ? x[j] : y);
    }
  }
}

template <int E>
__device__ __forceinline__ void sort_desc(u64 (&x)[E], int lane) {
  constexpr int N = 32 * E;
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int d = k >> 1; d > 0; d >>= 1) bitonic_stage<E>(x, lane, k, d);
  }
}

// run := top-N of run and x, both sorted desc, sorted desc.  The elementwise
// max of run against x reversed is that top-N as a bitonic sequence (the
// half-cleaner); log2(N) stages then sort it.
template <int E>
__device__ __forceinline__ void merge_desc_into(u64 (&run)[E], const u64 (&x)[E], int lane) {
  constexpr int N = 32 * E;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const u64 y = __shfl_sync(kFull, x[E - 1 - j], 31 - lane);   // element N-1-e
    run[j] = run[j] > y ? run[j] : y;
  }
#pragma unroll
  for (int d = N >> 1; d > 0; d >>= 1) bitonic_stage<E>(run, lane, 2 * N, d);
}

template <int E>
__global__ void __launch_bounds__(kMaxWarps * 32)
tile_topk_kernel(const float* __restrict__ scores, long long ld, int R, int W, int b,
                 int id_offset, const float* __restrict__ carry_s,
                 const int32_t* __restrict__ carry_i, float* __restrict__ out_s,
                 int32_t* __restrict__ out_i) {
  constexpr int N = 32 * E;                  // running width, max(b, 32)
  constexpr int kCap = N + kStep;            // candidate buffer a warp
  extern __shared__ u64 smem[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= R) return;                      // the whole warp
  u64* buf = smem + (threadIdx.x >> 5) * kCap;
  const float* srow = scores + static_cast<long long>(row) * ld;
  const uint32_t base = static_cast<uint32_t>(b);   // tile column c: position b + c
  const long long orow = static_cast<long long>(row) * b;

  u64 run[E];                                // the running top-N, sorted desc
#pragma unroll
  for (int j = 0; j < E; ++j) run[j] = 0ull;   // below every entry
  u64 thr = 0ull;
  int cnt = 0;                               // keys in buf, warp-uniform
  const unsigned below = (1u << lane) - 1u;
  const float neg_inf = -__int_as_float(0x7f800000);

  auto offer = [&](u64 key, bool ok) {
    const bool pass = ok && key > thr;
    const unsigned m = __ballot_sync(kFull, pass);
    if (pass) buf[cnt + __popc(m & below)] = key;
    cnt += __popc(m);
  };

  // Step -1 offers the carry (positions 0..b-1, in any order).  Step 0
  // covers the first 128 columns (so that the threshold rises early), step
  // s >= 1 the next kStep; every step starts at a column c0 = -mis (mod 4),
  // so that a lane's four columns are one aligned float4 wherever they all
  // lie inside the row.  Columns in [W, max(W, b)) are -inf padding.  One
  // drain site: the sort and merge below are instantiated once.
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(srow) >> 2) & 3);
  const int wv = max(W, b);
  for (int step = carry_s != nullptr ? -1 : 0;; ++step) {
    const int c0 = step <= 0 ? -mis : (step - 1) * kStep + 128 - mis;
    const int width = step == 0 ? 128 : kStep;   // columns of this step
    const bool last = step >= 0 && c0 + width >= wv;
    if (step < 0) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int e = lane * E + j;
        offer(make_key(e < b ? carry_s[orow + e] : 0.f, static_cast<uint32_t>(e)), e < b);
      }
    } else {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + (u * 32 + lane) * 4;
        if (u * 128 < width && c >= 0 && c + 3 < W) {
          v[u] = *reinterpret_cast<const float4*>(srow + c);
        } else {   // the ragged head and tail, padding, or past the step
          const bool in = u * 128 < width;
          v[u].x = (in && c >= 0 && c < W) ? srow[c] : neg_inf;
          v[u].y = (in && c + 1 >= 0 && c + 1 < W) ? srow[c + 1] : neg_inf;
          v[u].z = (in && c + 2 >= 0 && c + 2 < W) ? srow[c + 2] : neg_inf;
          v[u].w = (in && c + 3 >= 0 && c + 3 < W) ? srow[c + 3] : neg_inf;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + (u * 32 + lane) * 4;
        const int hi = u * 128 < width ? wv : 0;   // offer nothing past the step
        const uint32_t p = base + static_cast<uint32_t>(c);
        offer(make_key(v[u].x, p), c >= 0 && c < hi);
        offer(make_key(v[u].y, p + 1), c + 1 >= 0 && c + 1 < hi);
        offer(make_key(v[u].z, p + 2), c + 2 >= 0 && c + 2 < hi);
        offer(make_key(v[u].w, p + 3), c + 3 >= 0 && c + 3 < hi);
      }
    }
    // merge buf's keys into run, N at a time; before the last step a
    // remainder of fewer than N keys moves to the buffer's front
    if (cnt >= N || (last && cnt > 0)) {
      __syncwarp();
      int g = 0;
      while (cnt - g >= (last ? 1 : N)) {
        const int rest = cnt - g;
        u64 x[E];
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int e = lane * E + j;
          x[j] = e < rest ? buf[g + e] : 0ull;
        }
        sort_desc<E>(x, lane);
        merge_desc_into<E>(run, x, lane);
        g += N;
      }
      const int rest = g < cnt ? cnt - g : 0;
      __syncwarp();
      for (int e = lane; e < rest; e += 32) buf[e] = buf[g + e];   // g >= N > rest
      __syncwarp();
      cnt = rest;
      thr = __shfl_sync(kFull, run[E - 1], 31);
    }
    if (last) break;
  }

#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = lane * E + j;
    if (e < b) {
      const u64 key = run[j];
      const uint32_t pos = key_pos(key);
      out_s[orow + e] = key_score(key);
      out_i[orow + e] = pos < base ? carry_i[orow + pos]
                                   : static_cast<int32_t>(pos - base) + id_offset;
    }
  }
}

template <int E>
int launch(const float* scores, long long ld, int R, int W, int b, int id_offset,
           const float* carry_s, const int32_t* carry_i, float* out_s, int32_t* out_i,
           cudaStream_t stream) {
  const size_t per_warp = static_cast<size_t>(32 * E + kStep) * sizeof(u64);
  int warps = static_cast<int>(kSmemBudget / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int grid = (R + warps - 1) / warps;
  tile_topk_kernel<E><<<grid, warps * 32, warps * per_warp, stream>>>(
      scores, ld, R, W, b, id_offset, carry_s, carry_i, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C ABI for ctypes.  scores: [R, W] f32 with row stride `ld` elements; b a
// power of two in [1, 1024]; carry_s [R, b] f32 and carry_i [R, b] int32,
// contiguous, or both null for no carry; out_s: [R, b] f32 and out_i: [R, b]
// int32, both contiguous.  Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 = launched).
extern "C" int pio_tile_topk(const void* scores, long long ld, int R, int W, int b,
                             int id_offset, const void* carry_s, const void* carry_i,
                             void* out_s, void* out_i, void* stream) {
  if ((carry_s == nullptr) != (carry_i == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scores);
  const float* cs = static_cast<const float*>(carry_s);
  const int32_t* ci = static_cast<const int32_t*>(carry_i);
  float* os = static_cast<float*>(out_s);
  int32_t* oi = static_cast<int32_t*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 1: case 2: case 4: case 8: case 16: case 32:
      return launch<1>(s, ld, R, W, b, id_offset, cs, ci, os, oi, st);
    case 64: return launch<2>(s, ld, R, W, b, id_offset, cs, ci, os, oi, st);
    case 128: return launch<4>(s, ld, R, W, b, id_offset, cs, ci, os, oi, st);
    case 256: return launch<8>(s, ld, R, W, b, id_offset, cs, ci, os, oi, st);
    case 512: return launch<16>(s, ld, R, W, b, id_offset, cs, ci, os, oi, st);
    case 1024: return launch<32>(s, ld, R, W, b, id_offset, cs, ci, os, oi, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
