// Row counts of an item-major int8 matrix, hand-written for Hopper (sm_90a):
//
//   out[r]  = sum_c m[r, c]             (int32; with `accumulate`, out[r] += ...)
//
// The CCO marginals (`_marginal`, ops/cco.py): the distinct users of each
// item row of a densified 0/1 matrix, summed for every count product of the
// dense, resident and chunked strategies.  It replaces no Pallas kernel (the
// JAX package leaves its marginals to an XLA sum).  It was added because the
// library's `torch.sum(m, 1, dtype=torch.int32)` first casts its whole int8
// input to int32: it reads every byte, writes it out again four times wider,
// then reads that back to reduce it, about 9x the bytes the sum needs.
//
// What bounds it on an H100: memory.  It reads each byte once and writes one
// int32 a row, (R*C + 4R) bytes at 3.35 TB/s; a [4,096 x 200,064] tile is
// 0.245 ms.  The arithmetic is one __dp4a per four bytes.
//
// Design:
//   - 16-byte loads (uint4), neighbouring lanes on neighbouring addresses,
//     four of them in flight a lane, with the streaming cache hint (each
//     byte is read once).  __dp4a(x, 0x01010101, acc) sums a word's four
//     signed bytes into an int32: exact for any int8, as torch.sum is.
//   - One block of 256 threads owns a row: each thread has 16-byte loads
//     of it from 4,096 bytes up (the cells' rows of 32,000 to 200,064
//     users), and the R blocks keep every SM busy even for a handful of
//     long rows.  The block reduces by warp shuffles, then across its eight
//     warps in shared memory; thread 0 writes (or adds) the result.  No
//     atomics: the sums are the same in every run and equal torch.sum's
//     bit for bit (an integer sum is exact in any order).  Measured on an
//     H100 at the cells' three shapes, in 5 paired rounds, it beat a warp a
//     row by 2.3-2.7% in every round (each side's rounds within 0.2%).
//     Shorter rows (tests, small apps) take the same geometry: their
//     launches cost little either way.
//   - Rows need no alignment (a row-strided view, C no multiple of 16): each
//     row reads its bytes up to the first 16-byte boundary and its ragged
//     tail one a lane, and the aligned body in between as uint4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                  // a block a row
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                     // 16-byte loads in flight a thread
constexpr int kOnes = 0x01010101;

__device__ __forceinline__ int sum16(uint4 v, int acc) {
  acc = __dp4a(static_cast<int>(v.x), kOnes, acc);
  acc = __dp4a(static_cast<int>(v.y), kOnes, acc);
  acc = __dp4a(static_cast<int>(v.z), kOnes, acc);
  return __dp4a(static_cast<int>(v.w), kOnes, acc);
}

// This thread's part of the sum of row p's C bytes (a thread takes at most
// one byte of the ragged head and one of the tail: each is under 16 bytes).
__device__ __forceinline__ int row_part(const int8_t* __restrict__ p, int C, int t) {
  const int to_boundary = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  const int head = to_boundary < C ? to_boundary : C;
  const int nvec = (C - head) >> 4;
  const uint4* __restrict__ body = reinterpret_cast<const uint4*>(p + head);
  int acc = 0;
  for (int v = t; v < nvec; v += kUnroll * kThreads) {
    // every load of a step issued before its sums, the last step's too
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = v + u * kThreads < nvec ? __ldcs(body + v + u * kThreads) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = sum16(x[u], acc);
  }
  const int tail = head + (nvec << 4);
  if (t < head) acc += p[t];
  if (t < C - tail) acc += p[tail + t];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
row_count_kernel(const int8_t* __restrict__ m, long long ld, int32_t* __restrict__ out,
                 int C, int accumulate) {
  __shared__ int part[kWarps];
  const long long row = blockIdx.x;
  int s = row_part(m + row * ld, C, threadIdx.x);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w];
    out[row] = accumulate ? out[row] + s : s;
  }
}

}  // namespace

// C ABI for ctypes.  m: [R, C] int8 with row stride `ld` bytes and unit
// column stride, rows at any alignment; out: [R] int32 contiguous, written,
// or added to where `accumulate` is nonzero.  R > 0.  Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int pio_row_count(const void* m, long long ld, void* out, int R, int C,
                             int accumulate, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const int8_t*>(m);
  auto* o = static_cast<int32_t*>(out);
  row_count_kernel<<<R, kThreads, 0, s>>>(in, ld, o, C, accumulate);
  return static_cast<int>(cudaGetLastError());
}
