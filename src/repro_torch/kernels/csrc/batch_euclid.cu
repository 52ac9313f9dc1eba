// batch_euclid: squared Euclidean distance, as a direct diff-square-sum.
//   cross form:    queries [Q, L] x series [N, L]            -> out [Q, N]
//   gathered form: queries [Q, L] x series[idx[Q, C]] ([M, L]) -> out [Q, C]
//
// Replaces the TPU kernel src/repro/kernels/batch_euclid.py
// (batch_euclid_pallas, pl.pallas_call at line 45; query [L] x series [N, L]),
// which the cross form covers at Q = 1.  The reference routes the multi-query
// form to plain jnp; here both forms are kernels, and the seed probe uses the
// gathered form so it never materializes its [Q, C, L] candidate rows.
//
// What bounds it on an H100: at the query path's shapes (Q = 64, L = 256, a
// leaf group's union-live rows, median 175 and at most ~1800) the cross form
// does 3 FP32 instructions per element pair (no FMA, see below) and reads
// each row once for all Q queries, so the FP32 instruction rate bounds its
// arithmetic; at those sizes a launch lasts a few microseconds, so what it
// pays in the end is latency: the copies in, one chain of dependent steps
// per warp, the stores.  The gathered form reads one row per pair and is bound by those
// bytes.  A tensor-core ||q||^2 + ||x||^2 - 2 q.x form would be faster but
// changes the bits and can go negative, so it is not used.
//
// Cross form, register-tiled.  The launch plan (the block's query tile, the L
// chunks, the grid) comes from the wrapper (kernels/batch_euclid.py:
// launch_plan); a block covers kWarpR rows.  A block copies its query tile and
// row tile into shared memory with cp.async (16-byte copies where rows are
// 16-byte aligned, else 4-byte ones; zeros past L), waits, and computes.  All
// of L is one chunk when it fits 48 KB (L <= 512 at 16 queries); a longer L
// loops over chunks in one buffer, each chunk's copy waited for before its
// compute (a second buffer, copying chunk c + 1 while chunk c computes, halves
// the chunk, and on an H100 was slower at L = 1024 and 4096:
// tools/compare_cross.py).  Each warp owns a register tile of kWarpQ x kWarpR
// (query, row) pairs; lane l keeps the partial of all 32 pairs over columns l,
// l + 32, ... (the lane order of ed_warp), loading each query and row value
// once per step for the whole tile (12 loads for 96 FP32 instructions), and a
// warp's 32 loads are 32 consecutive words of one row (no bank conflicts, no
// padding needed).  The 32 partials of each pair are then folded in ed_warp's
// tree by 31 shuffles: at each of the 5 steps a lane keeps half of its pairs
// and adds its xor-partner's partials of them, so after the last step lane l
// holds the distance of pair (l / kWarpR, l % kWarpR); the lanes of a query's
// rows store 8 adjacent floats.  IEEE addition is commutative, so the lane that
// adds its partner's partial to its own gets the bits of ed_warp's butterfly:
// every path gives a pair the same bits.
//
// Gathered form: one warp per (query, candidate), ed_warp reading both
// vectors from global memory (L1/L2 serve the reuse of overlapping seed
// windows).
// FMA contraction: none (see common.cuh).
#include "common.cuh"

namespace coconut {
namespace {

constexpr int kThreads = 256;          // the gathered form's block
constexpr int kWarps = kThreads / kWarp;
constexpr int kWarpQ = 4;              // a warp's register tile: queries
constexpr int kWarpR = 8;              //   x rows (kWarpQ * kWarpR == 32)
// A block has at most 4 warps (the plan's 16 queries x 8 rows), and five
// blocks must fit on an SM at once: the densest launch has 4.5 per SM, and
// at 98 registers a thread (the compiler's choice without the bound) only
// four fit, which cost a fifth of its time on an H100.
constexpr int kMaxThreads = 128;
constexpr int kMinBlocks = 5;
constexpr int kDefaultSmem = 48 * 1024;   // no opt-in attribute needed
static_assert(kWarpQ * kWarpR == kWarp, "one pair per lane after the fold");

struct Cross {
  const float* queries;   // [nq, L]
  const float* series;    // [n, L]
  float* out;             // [nq, n]
  int nq, n, L;
  int qtile, lchunk, chunks;   // the launch plan
  bool vec;               // rows may be copied 16 B at once
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async with a source size: bytes past src_bytes are written as zeros.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying columns [c0, c0 + width) of the block's tq queries and tr
// rows into buf ([qtile + kWarpR][lchunk]: queries, then rows); columns past
// L are zeros, so they add exactly 0 to a partial.  Warps take tile rows,
// lanes the 16-byte (or 4-byte) pieces of a row.
__device__ __forceinline__ void stage(const Cross& a, float* buf, int q0,
                                      int r0, int tq, int tr, int c0,
                                      int width) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  for (int t = warp; t < tq + tr; t += warps) {
    const bool is_q = t < tq;
    const long long row = is_q ? q0 + t : r0 + (t - tq);
    const float* src = (is_q ? a.queries : a.series) + row * a.L;
    float* dst = buf + (is_q ? t : a.qtile + (t - tq)) * a.lchunk;
    if (a.vec) {
      for (int v = lane * 4; v < width; v += kWarp * 4) {
        const int col = c0 + v;
        copy16(dst + v, src + min(col, a.L - 4), col < a.L ? 16 : 0);
      }
    } else {
      for (int v = lane; v < width; v += kWarp) {
        const int col = c0 + v;
        copy4(dst + v, src + min(col, a.L - 1), col < a.L ? 4 : 0);
      }
    }
  }
}

// One step of the fold of 2 * O pairs' partials, v[0, 2O): a lane keeps
// pairs [O, 2O) when its bit O is set, else [0, O), adds its xor-partner's
// partials of them (the partner keeps the other half) and moves the kept
// half to v[0, O).  At step O a partial is the sum of lanes l and l ^ O's
// partials of the step before, ed_warp's butterfly tree.
template <int O>
__device__ __forceinline__ void fold_step(float* v, int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int p = 0; p < O; ++p) {
    const float keep = upper ? v[p + O] : v[p];
    const float send = upper ? v[p] : v[p + O];
    v[p] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, O));
  }
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
euclid_cross_kernel(const Cross a) {
  extern __shared__ float4 smem4[];
  float* const buf = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int q0 = blockIdx.y * a.qtile;
  const int r0 = blockIdx.x * kWarpR;
  const int tq = min(a.qtile, a.nq - q0);
  const int tr = min(kWarpR, a.n - r0);
  const int lpad = (a.L + kWarp - 1) / kWarp * kWarp;
  const int wq = warp * kWarpQ;     // this warp's queries in the block tile
  const bool busy = wq < tq;

  float acc[kWarpQ][kWarpR];
#pragma unroll
  for (int i = 0; i < kWarpQ; ++i)
#pragma unroll
    for (int j = 0; j < kWarpR; ++j) acc[i][j] = 0.f;

  stage(a, buf, q0, r0, tq, tr, 0, min(a.lchunk, lpad));
  commit();
  for (int c = 0; c < a.chunks; ++c) {
    const int c0 = c * a.lchunk;
    const int width = min(a.lchunk, lpad - c0);
    if (c > 0) {
      __syncthreads();                   // every warp is done with chunk c-1
      stage(a, buf, q0, r0, tq, tr, c0, width);
      commit();
    }
    wait_pending<0>();
    __syncthreads();
    if (busy) {
      const float* sq = buf + wq * a.lchunk + lane;
      const float* sx = buf + a.qtile * a.lchunk + lane;
      const int steps = width / kWarp;
#pragma unroll 2
      for (int s = 0; s < steps; ++s) {
        const int col = s * kWarp;
        float qv[kWarpQ], xv[kWarpR];
#pragma unroll
        for (int i = 0; i < kWarpQ; ++i) qv[i] = sq[i * a.lchunk + col];
#pragma unroll
        for (int j = 0; j < kWarpR; ++j) xv[j] = sx[j * a.lchunk + col];
#pragma unroll
        for (int i = 0; i < kWarpQ; ++i)
#pragma unroll
          for (int j = 0; j < kWarpR; ++j) {
            const float d = __fsub_rn(xv[j], qv[i]);
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(d, d));
          }
      }
    }
  }
  if (!busy) return;

  // Fold: v[p] is pair p = i * kWarpR + j; after the steps with offsets
  // 16, 8, 4, 2, 1 lane l holds pair l in v[0].
  float v[kWarp];
#pragma unroll
  for (int i = 0; i < kWarpQ; ++i)
#pragma unroll
    for (int j = 0; j < kWarpR; ++j) v[i * kWarpR + j] = acc[i][j];
  fold_step<16>(v, lane);
  fold_step<8>(v, lane);
  fold_step<4>(v, lane);
  fold_step<2>(v, lane);
  fold_step<1>(v, lane);
  const int q = q0 + wq + lane / kWarpR;
  const int r = r0 + lane % kWarpR;
  if (q < a.nq && r < a.n) a.out[static_cast<long long>(q) * a.n + r] = v[0];
}

__global__ void __launch_bounds__(kThreads)
euclid_gather_kernel(const float* __restrict__ queries,
                     const float* __restrict__ series,
                     const long long* __restrict__ idx, float* __restrict__ out,
                     int nq, long long c, int L) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long pair = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (pair >= nq * c) return;
  const long long qi = pair / c;
  const float d = ed_warp(series + idx[pair] * L, queries + qi * L, L, lane);
  if (lane == 0) out[pair] = d;
}

}  // namespace
}  // namespace coconut

// C entry points.  Return a cudaError_t (0 on success).

// Cross form: one launch, no fill.  Requires nq >= 1, 1 <= n < 2^31,
// L >= 1, contiguous rows, and the wrapper's launch plan: qtile queries
// per block (whole warp tiles, at most kMaxThreads threads), chunks of
// lchunk columns (whole 32-column steps) that cover L, and a grid of
// (grid_x, grid_y) blocks that covers every pair.  What guards memory is
// checked here: the tile in threads and the staged chunk within the
// default 48 KB of shared memory (so no per-call cudaFuncSetAttribute).
extern "C" int coconut_euclid_cross(const float* queries, const float* series,
                                    float* out, int nq, int n, int L,
                                    int qtile, int lchunk, int chunks,
                                    int grid_x, int grid_y, void* stream) {
  using namespace coconut;
  const int threads = kWarp * (qtile / kWarpQ);
  const long long smem = 4LL * (qtile + kWarpR) * lchunk;
  const bool ok = nq >= 1 && n >= 1 && L >= 1 && qtile >= kWarpQ &&
                  qtile % kWarpQ == 0 && threads <= kMaxThreads &&
                  lchunk >= kWarp && lchunk % kWarp == 0 && chunks >= 1 &&
                  static_cast<long long>(chunks) * lchunk >= L &&
                  smem <= kDefaultSmem;
  if (!ok) return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const Cross a{queries, series, out, nq, n, L, qtile, lchunk, chunks,
                L % 4 == 0 && aligned(queries) && aligned(series)};
  euclid_cross_kernel<<<dim3(grid_x, grid_y), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// Gathered form.  idx holds row numbers of series, each in [0, M); the caller
// checks the range.  Requires nq >= 1, c >= 1, L >= 1.
extern "C" int coconut_euclid_gather(const float* queries, const float* series,
                                     const long long* idx, float* out, int nq,
                                     long long c, int L, void* stream) {
  using namespace coconut;
  const long long pairs = static_cast<long long>(nq) * c;
  const dim3 grid(static_cast<unsigned>((pairs + kWarps - 1) / kWarps));
  euclid_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      queries, series, idx, out, nq, c, L);
  return cudaGetLastError();
}
