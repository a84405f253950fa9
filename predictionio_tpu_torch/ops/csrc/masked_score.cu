// Fused masked score product for ALS serving, hand-written for Hopper (sm_90a).
//
//   out[b, i] = dot(U[b, :], V[i, :]) + bias[i]      (fp32, fp32 accumulation)
//   out[b, i] = -inf                                  where mask[b, i] > 0
//
// Replaces the TPU kernel `_score_kernel` / `_masked_score_matmul` in
// predictionio_tpu/ops/pallas_kernels.py (pl.pallas_call at line 105).  As
// there, the bias add and the mask are applied to the scores while they are
// still in registers, so the [B, I] score matrix is written to device memory
// once and never read back.
//
// What bounds it on an H100: memory.  Serving calls it with B = 1 (one query)
// or B <= 64 (one serving micro-batch) against a catalog of I ~ 1e5 items at
// rank K = 32.  At B = 1 one launch reads V (12.8 MB) and writes 0.4 MB: ~0.06
// operations per byte.  At B = 64 it writes 25.6 MB of scores and reads 6.4 MB
// of mask besides V; the fp32 work (0.41 GFLOP, ~6 us at 67 TFLOP/s) is under
// half the bytes' ~13 us at 3.35 TB/s.  Only at B = 256, K = 64 does the work
// (~49 us) tie the bytes (~46 us).  The tensor cores are not used: their fp32
// path is TF32, which would break the 1e-5 parity with the JAX reference.
//
// Two paths, chosen by B:
//
// B <= 8: a streaming pass over V (`stream_kernel`).  A warp scores 32 items
//   a step: eight lanes share an item and read its row as 16-byte loads
//   (ld.global.nc.v4), so one warp instruction covers 4 items in 4 whole
//   128-byte lines, and each lane issues its 8 items' loads before any FMA (8
//   independent 16-byte loads in flight a lane).  A butterfly of shuffles over
//   the 8 lanes (4 + 2 + 1 exchanges a row) leaves lane l with the finished
//   dot product of item l, so each row's 32 scores are stored as whole
//   128-byte lines; lane l's mask entries and bias are loaded before V's rows,
//   so their latency is not a second round.  U's B rows are read from
//   L1 beside V.  The grid is one resident wave striding over the 32-item
//   groups, so at B = 1, I = 1e5 every SM has its ~97 KB share of V in flight
//   from the start.  A lane keeps 8 partial sums for each of NB rows (NB the
//   least of 1, 2, 4, 8 that is >= B), so a single query carries no idle row.
//
// B > 8: a register-blocked tile, pipelined (`tiled_kernel`).  A block owns
//   32 rows x 128 items a unit (128 threads, B <= 32) or 64 rows x 128 items
//   (256 threads) and walks its units, a grid-stride loop over one resident
//   wave of blocks.  The U and V chunks of 32 k go through a 3-stage ring of
//   cp.async 16-byte copies into shared memory, so the next two steps' loads
//   (the next units', at K = 32) overlap this step's FMAs.  Each thread
//   accumulates 4 rows x 8 items: each V value read from shared memory feeds
//   4 rows and each U value 8 items, and shared-memory rows are XOR-swizzled
//   so the 16-byte reads of 8 neighbouring threads hit distinct banks.  The
//   walk keeps a cursor (no 64-bit division a step).  A thread's items are
//   two runs of 4, so the epilogue stores 16-byte float4s wherever the score
//   row allows.  The uint8 mask is read before the unit's last compute step,
//   as the two aligned 32-bit words around each run of 4 bytes, so its
//   latency hides under the FMAs and a row of any alignment takes the same
//   two loads (the main path's mask is a row-strided view of stride I + 1, so
//   its rows start at every alignment); bytes at a row's ragged head and
//   tail are read one by one, so nothing outside the row is touched.  An f32
//   mask is read in the epilogue, as float4s where aligned.  What still
//   holds B = 64 back (PERF.md): the epilogue's 25.6 MB of stores and 6.4 MB
//   of mask take most of the time, and a block's three units at I = 1e5 leave
//   little room to overlap them with the loads and FMAs.
//
// Any K, I and mask stride: K not a multiple of 4 (or U, V off 16-byte
// alignment) takes 4-byte loads and 4-byte cp.async copies instead of 16-byte
// ones; rows, items and k outside the matrices read as 0 and are not stored.
// Nothing is padded by the caller.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;   // a streaming block

// streaming path
constexpr int kStreamMaxRows = 8;
constexpr int kLanesPerItem = 8;
constexpr int kGroup = 32;   // items a warp step

// tiled path
constexpr int kTI = 128;     // items a unit
constexpr int kKC = 32;      // k a pipeline step
constexpr int kQ = kKC / 4;  // float4s a row of a step
constexpr int kStages = 3;

__device__ __forceinline__ bool masked(uint8_t m) { return m != 0; }
__device__ __forceinline__ bool masked(float m) { return m > 0.f; }

__host__ __device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Four floats of a row from k = 4c on: one 16-byte read-only load when VEC
// (K % 4 == 0, row base 16-byte aligned), else four bounded 4-byte loads.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c, int K) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(row) + c);
  const int k = 4 * c;
  return make_float4(k < K ? __ldg(row + k) : 0.f, k + 1 < K ? __ldg(row + k + 1) : 0.f,
                     k + 2 < K ? __ldg(row + k + 2) : 0.f, k + 3 < K ? __ldg(row + k + 3) : 0.f);
}

__device__ __forceinline__ float dot4(float4 a, float4 w, float acc) {
  acc = fmaf(a.x, w.x, acc);
  acc = fmaf(a.y, w.y, acc);
  acc = fmaf(a.z, w.z, acc);
  return fmaf(a.w, w.w, acc);
}

// Sum 8 partial dot products (of items j = 0..7) over the 8 lanes that share
// them; lane r of the 8 (r = lane & 7) returns the total of item j = r.  Each
// step keeps half the items and hands the other half to the partner lane.
__device__ __forceinline__ float butterfly8(const float (&p)[8], int r) {
  float h[4], q[2];
  const bool b2 = r & 4, b1 = r & 2, b0 = r & 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = b2 ? p[j] : p[j + 4];
    h[j] = (b2 ? p[j + 4] : p[j]) + __shfl_xor_sync(kFull, send, 4);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = b1 ? h[j] : h[j + 2];
    q[j] = (b1 ? h[j + 2] : h[j]) + __shfl_xor_sync(kFull, send, 2);
  }
  const float send = b0 ? q[0] : q[1];
  return (b0 ? q[1] : q[0]) + __shfl_xor_sync(kFull, send, 1);
}

template <int NB, bool VEC, typename MaskT>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const MaskT* __restrict__ mask, long long mask_ld,
              const float* __restrict__ bias, int has_bias,
              float* __restrict__ out, int B, int I, int K, long long groups) {
  const int lane = threadIdx.x & 31;
  const int g = lane / kLanesPerItem, r = lane % kLanesPerItem;
  const int chunks = (K + 3) / 4;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long grp = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
       grp < groups; grp += warps) {   // warp-uniform
    const long long base = grp * kGroup;
    // this lane's item after the butterfly: its mask entries and bias are
    // loaded first, so their latency runs beside V's
    const long long item = base + lane;
    MaskT m[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) m[b] = b < B && item < I ? mask[b * mask_ld + item] : MaskT(0);
    const float bi = has_bias && item < I ? bias[item] : 0.f;
    float acc[NB][8];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[b][j] = 0.f;
    // lane (g, r) reads float4 c of items base + 8 g + j, j = 0..7, so that
    // after the butterfly lane 8 g + r holds item base + 8 g + r
    for (int c = r; c < chunks; c += kLanesPerItem) {
      float4 w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long item = base + g * 8 + j;
        w[j] = item < I ? load4<VEC>(v + item * K, c, K) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < B) {   // uniform
          const float4 a = load4<VEC>(u + static_cast<long long>(b) * K, c, K);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[b][j] = dot4(a, w[j], acc[b][j]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b >= B) break;   // uniform
      const float s = butterfly8(acc[b], r) + bi;
      if (item < I) out[static_cast<long long>(b) * I + item] = masked(m[b]) ? -CUDART_INF_F : s;
    }
  }
}

// -- the tiled path -------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// One pipeline step's operands: a 32-k chunk of the unit's TB rows of U and
// 128 items of V.  Float4 q of row x sits at slot q ^ swizzle(x), so that the
// compute loop's 16-byte reads of 8 neighbouring threads hit 8 distinct bank
// groups.
template <int TB>
struct Stage {
  float4 u[TB][kQ];
  float4 v[kTI][kQ];
};

__device__ __forceinline__ int u_swz(int row) { return row & 7; }
__device__ __forceinline__ int v_swz(int item) { return (item >> 2) & 7; }

// Copy the operands of the step at (b0, i0, k0) into `st`; what lies outside
// U or V is zero-filled (source size 0).
template <int TB, int NT, bool VEC>
__device__ __forceinline__ void load_step(Stage<TB>& st, const float* __restrict__ u,
                                          const float* __restrict__ v, int B, int I, int K,
                                          int b0, int i0, int k0) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int e = tid; e < kTI * kQ; e += NT) {
      const int it = e / kQ, q = e % kQ, i = i0 + it, k = k0 + 4 * q;
      const bool ok = i < I && k < K;
      cp_async16(&st.v[it][q ^ v_swz(it)], ok ? v + static_cast<long long>(i) * K + k : v,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int e = tid; e < TB * kQ; e += NT) {
      const int rr = e / kQ, q = e % kQ, b = b0 + rr, k = k0 + 4 * q;
      const bool ok = b < B && k < K;
      cp_async16(&st.u[rr][q ^ u_swz(rr)], ok ? u + static_cast<long long>(b) * K + k : u,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kTI * kKC; e += NT) {
      const int it = e / kKC, kk = e % kKC, i = i0 + it, k = k0 + kk;
      const bool ok = i < I && k < K;
      float* dst = reinterpret_cast<float*>(&st.v[it][(kk / 4) ^ v_swz(it)]) + (kk & 3);
      cp_async4(dst, ok ? v + static_cast<long long>(i) * K + k : v, ok ? 4 : 0);
    }
    for (int e = tid; e < TB * kKC; e += NT) {
      const int rr = e / kKC, kk = e % kKC, b = b0 + rr, k = k0 + kk;
      const bool ok = b < B && k < K;
      float* dst = reinterpret_cast<float*>(&st.u[rr][(kk / 4) ^ u_swz(rr)]) + (kk & 3);
      cp_async4(dst, ok ? u + static_cast<long long>(b) * K + k : u, ok ? 4 : 0);
    }
  }
}

// Four consecutive floats of a row from column i (of n): one float4 where
// aligned and inside the row, else element by element (0 outside the row).
__device__ __forceinline__ float4 read4(const float* __restrict__ row, int i, int n) {
  if (i + 3 < n && aligned(row + i, 16)) return *reinterpret_cast<const float4*>(row + i);
  return make_float4(row[i], i + 1 < n ? row[i + 1] : 0.f, i + 2 < n ? row[i + 2] : 0.f,
                     i + 3 < n ? row[i + 3] : 0.f);
}

// A uint8 mask's bytes [i, i + 4) of a row, as the two aligned 32-bit words
// around them: loaded before the unit's last compute step, so that their
// latency hides under the FMAs.  Rows of any alignment take the same two
// loads; where the words would reach outside the row (its ragged head and
// tail), the bytes are read one by one into the same places.
struct MaskWindow {
  uint32_t lo, hi;
};

__device__ __forceinline__ int byte_offset(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
}

__device__ __forceinline__ void prefetch_mask(MaskWindow& w, const uint8_t* __restrict__ row,
                                              int i, int n) {
  const int off = byte_offset(row + i);
  if (i - off >= 0 && i - off + 8 <= n) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row + i - off);
    w.lo = __ldg(p);
    w.hi = __ldg(p + 1);
  } else {
    unsigned long long x = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i + j < n) x |= static_cast<unsigned long long>(row[i + j]) << (8 * (off + j));
    }
    w.lo = static_cast<uint32_t>(x);
    w.hi = static_cast<uint32_t>(x >> 32);
  }
}

// An f32 mask is read in the epilogue itself (16 registers a thread would
// hold it otherwise); ALS serving's masks are uint8.
__device__ __forceinline__ void prefetch_mask(MaskWindow&, const float* __restrict__, int, int) {}

// Which of the four mask entries from column i are set.
__device__ __forceinline__ void mask4(const MaskWindow& w, const uint8_t* __restrict__ row,
                                      int i, int, bool (&m)[4]) {
  const uint32_t bytes = __funnelshift_r(w.lo, w.hi, 8 * byte_offset(row + i));
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = (bytes >> (8 * j)) & 0xffu;
}

__device__ __forceinline__ void mask4(const MaskWindow&, const float* __restrict__ row, int i,
                                      int n, bool (&m)[4]) {
  const float4 w = read4(row, i, n);
  m[0] = w.x > 0.f;
  m[1] = w.y > 0.f;
  m[2] = w.z > 0.f;
  m[3] = w.w > 0.f;
}

// A block's place in its walk: the unit (item tile i0, row tile b0) and the
// k-chunk.  Units advance by gridDim.x; the one division a unit is skipped
// when there is one row tile (every serving batch).
struct Cursor {
  long long unit;
  int kc, b0, i0;
};

template <int TB>
__device__ __forceinline__ void place(Cursor& c, int b_tiles) {
  if (b_tiles == 1) {
    c.b0 = 0;
    c.i0 = static_cast<int>(c.unit * kTI);
  } else {
    const long long it = c.unit / b_tiles;
    c.b0 = static_cast<int>(c.unit - it * b_tiles) * TB;
    c.i0 = static_cast<int>(it * kTI);
  }
}

template <int TB>
__device__ __forceinline__ Cursor start(int b_tiles) {
  Cursor c{static_cast<long long>(blockIdx.x), 0, 0, 0};
  place<TB>(c, b_tiles);
  return c;
}

template <int TB>
__device__ __forceinline__ void advance(Cursor& c, int nk, int b_tiles) {
  if (++c.kc == nk) {
    c.kc = 0;
    c.unit += gridDim.x;
    place<TB>(c, b_tiles);
  }
}

// NT threads, 16 along items x NT / 16 along rows; RPT rows a thread (ty +
// NT / 16 r): a unit of NT / 16 x RPT rows x 128 items
template <int RPT, int NT, bool VEC, typename MaskT>
__global__ void __launch_bounds__(NT, NT == 128 ? 3 : 2)
tiled_kernel(const float* __restrict__ u, const float* __restrict__ v,
             const MaskT* __restrict__ mask, long long mask_ld,
             const float* __restrict__ bias, int has_bias,
             float* __restrict__ out, int B, int I, int K, int b_tiles, long long units) {
  constexpr int RY = NT / 16, TB = RY * RPT;
  extern __shared__ float4 smem[];
  Stage<TB>* stages = reinterpret_cast<Stage<TB>*>(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nk = K > 0 ? (K + kKC - 1) / kKC : 1;
  const long long mine = units > blockIdx.x ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = mine * nk;
  // The block walks units blockIdx.x + n gridDim.x, each k-chunk by k-chunk;
  // `cur` is the step computed, `pre` the step loaded kStages - 1 ahead.  The
  // b tiles of one item tile are neighbouring units, so V is read from device
  // memory about once.
  Cursor cur = start<TB>(b_tiles), pre = cur;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_step<TB, NT, VEC>(stages[s], u, v, B, I, K, pre.b0, pre.i0, pre.kc * kKC);
      advance<TB>(pre, nk, b_tiles);
    }
    cp_async_commit();   // one group a step, empty or not: the wait counts groups
  }
  float acc[RPT][8];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  MaskWindow win[RPT][2];

  for (long long t = 0, stage = 0; t < steps; ++t, stage = stage + 1 == kStages ? 0 : stage + 1) {
    cp_async_wait_stages();   // step t has landed (this thread's copies) ...
    __syncthreads();          // ... everyone's, and step t - 1's stage is free
    if (t + kStages - 1 < steps) {
      load_step<TB, NT, VEC>(stages[stage == 0 ? kStages - 1 : stage - 1], u, v, B, I, K,
                             pre.b0, pre.i0, pre.kc * kKC);
      advance<TB>(pre, nk, b_tiles);
    }
    cp_async_commit();
    const int b0 = cur.b0, i0 = cur.i0;
    const bool last = cur.kc == nk - 1;   // the unit's last k-chunk: epilogue after it
    advance<TB>(cur, nk, b_tiles);
    if (last) {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = b0 + ty + RY * r, i = i0 + 4 * tx + 64 * h;
          if (b < B && i < I) prefetch_mask(win[r][h], mask + b * mask_ld, i, I);
        }
    }
    const Stage<TB>& st = stages[stage];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      float4 w[8];   // items 4 tx + 64 (j / 4) + j % 4: swizzle tx & 7
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = st.v[4 * tx + 64 * (j / 4) + j % 4][q ^ (tx & 7)];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 a = st.u[ty + RY * r][q ^ u_swz(ty)];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = dot4(a, w[j], acc[r][j]);
      }
    }
    if (!last) continue;

    // epilogue of the unit: bias and mask on the registers, 16-byte stores
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 4 * tx + 64 * h;
      if (i >= I) continue;
      const float4 bi = has_bias ? read4(bias, i, I) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int b = b0 + ty + RY * r;
        if (b >= B) continue;
        bool m[4];
        mask4(win[r][h], mask + b * mask_ld, i, I, m);
        const float ninf = -CUDART_INF_F;
        const float4 s = make_float4(m[0] ? ninf : acc[r][4 * h] + bi.x,
                                     m[1] ? ninf : acc[r][4 * h + 1] + bi.y,
                                     m[2] ? ninf : acc[r][4 * h + 2] + bi.z,
                                     m[3] ? ninf : acc[r][4 * h + 3] + bi.w);
        float* orow = out + static_cast<long long>(b) * I;
        if (i + 3 < I && aligned(orow + i, 16)) {
          *reinterpret_cast<float4*>(orow + i) = s;
        } else {
          orow[i] = s.x;
          if (i + 1 < I) orow[i + 1] = s.y;
          if (i + 2 < I) orow[i + 2] = s.z;
          if (i + 3 < I) orow[i + 3] = s.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

// One wave of resident blocks of `kernel` with `smem` dynamic shared bytes.
template <typename Kernel>
long long wave(Kernel kernel, int threads, int smem) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return static_cast<long long>(sm_count()) * (n > 0 ? n : 1);
}

template <int NB, bool VEC, typename MaskT>
void launch_stream(const float* u, const float* v, const MaskT* mask, long long mask_ld,
                   const float* bias, int has_bias, float* out, int B, int I, int K,
                   cudaStream_t stream) {
  static const long long cap = wave(stream_kernel<NB, VEC, MaskT>, kThreads, 0);
  const long long groups = (static_cast<long long>(I) + kGroup - 1) / kGroup;
  const long long blocks = (groups + kThreads / 32 - 1) / (kThreads / 32);
  stream_kernel<NB, VEC, MaskT><<<static_cast<int>(blocks < cap ? blocks : cap), kThreads, 0,
                                  stream>>>(u, v, mask, mask_ld, bias, has_bias, out, B, I, K,
                                            groups);
}

template <int RPT, int NT, bool VEC, typename MaskT>
void launch_tiled(const float* u, const float* v, const MaskT* mask, long long mask_ld,
                  const float* bias, int has_bias, float* out, int B, int I, int K,
                  cudaStream_t stream) {
  constexpr int TB = NT / 16 * RPT;
  constexpr int smem = kStages * static_cast<int>(sizeof(Stage<TB>));   // 60 or 72 KB
  static const long long cap = [] {
    cudaFuncSetAttribute(tiled_kernel<RPT, NT, VEC, MaskT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return wave(tiled_kernel<RPT, NT, VEC, MaskT>, NT, smem);
  }();
  const int b_tiles = (B + TB - 1) / TB;
  const long long units = static_cast<long long>(b_tiles) * ((I + kTI - 1) / kTI);
  tiled_kernel<RPT, NT, VEC, MaskT><<<static_cast<int>(units < cap ? units : cap), NT, smem,
                                      stream>>>(u, v, mask, mask_ld, bias, has_bias, out, B, I, K,
                                            b_tiles, units);
}

// route of a launch, reported to the caller: the streaming pass or the tile
constexpr int kRouteStream = 0;
constexpr int kRouteTiled = 1;

template <bool VEC, typename MaskT>
int launch(const float* u, const float* v, const MaskT* mask, long long mask_ld,
           const float* bias, int has_bias, float* out, int B, int I, int K,
           cudaStream_t s) {
  if (B == 1) {
    launch_stream<1, VEC>(u, v, mask, mask_ld, bias, has_bias, out, B, I, K, s);
  } else if (B == 2) {
    launch_stream<2, VEC>(u, v, mask, mask_ld, bias, has_bias, out, B, I, K, s);
  } else if (B <= 4) {
    launch_stream<4, VEC>(u, v, mask, mask_ld, bias, has_bias, out, B, I, K, s);
  } else if (B <= kStreamMaxRows) {
    launch_stream<kStreamMaxRows, VEC>(u, v, mask, mask_ld, bias, has_bias, out, B, I, K, s);
  } else if (B <= 32) {   // a 32-row unit: no idle rows at B = 17..32
    launch_tiled<4, 128, VEC>(u, v, mask, mask_ld, bias, has_bias, out, B, I, K, s);
    return kRouteTiled;
  } else {
    launch_tiled<4, 256, VEC>(u, v, mask, mask_ld, bias, has_bias, out, B, I, K, s);
    return kRouteTiled;
  }
  return kRouteStream;
}

template <typename MaskT>
int dispatch(const float* u, const float* v, const MaskT* mask, long long mask_ld,
             const float* bias, int has_bias, float* out, int B, int I, int K,
             cudaStream_t s) {
  // 16-byte operand loads need every row of U and V on a 16-byte boundary
  if (K % 4 == 0 && aligned(u, 16) && aligned(v, 16)) {
    return launch<true>(u, v, mask, mask_ld, bias, has_bias, out, B, I, K, s);
  }
  return launch<false>(u, v, mask, mask_ld, bias, has_bias, out, B, I, K, s);
}

}  // namespace

// C ABI for ctypes.  u: [B, K] f32, v: [I, K] f32, both contiguous; mask:
// [B, I] with row stride mask_ld >= I elements (any alignment), uint8 or bool
// (mask_is_f32 = 0) or f32 (mask_is_f32 = 1); bias: [I] f32, read only when
// has_bias != 0; out: [B, I] f32 contiguous.  B, I >= 1, K >= 0.  Launches on
// `stream` without synchronising, writes the route it took to *route (0 the
// streaming pass, 1 the tile) and returns cudaGetLastError() (0 = launched).
extern "C" int pio_masked_score(const void* u, const void* v, const void* mask,
                                int mask_is_f32, long long mask_ld,
                                const void* bias, int has_bias, void* out,
                                int B, int I, int K, int* route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fu = static_cast<const float*>(u);
  const float* fv = static_cast<const float*>(v);
  const float* fb = static_cast<const float*>(bias);
  float* fo = static_cast<float*>(out);
  if (mask_is_f32) {
    *route = dispatch(fu, fv, static_cast<const float*>(mask), mask_ld, fb, has_bias, fo, B, I,
                      K, s);
  } else {
    *route = dispatch(fu, fv, static_cast<const uint8_t*>(mask), mask_ld, fb, has_bias, fo, B,
                      I, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}
