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
// leaf group of <= 2000 rows) the cross form does 3 flops per element pair and
// reads each row once for all Q queries, so FP32 operations bound it
// (~96 flops per byte moved); the gathered form reads one row per pair and is
// bound by those bytes.  A tensor-core ||q||^2 + ||x||^2 - 2 q.x form would be
// faster but changes the bits and can go negative, so it is not used.
//
// Design: every pair is computed by one warp with ed_warp (common.cuh), whose
// lane-strided order depends only on L.  Cross form: a block holds a tile of
// kQTile queries in shared memory; each of its 8 warps copies one row at a time
// into its own shared slot and runs it against every query of the tile.
// Gathered form: one warp per (query, candidate), reading both vectors from
// global memory (L1/L2 serve the reuse of overlapping seed windows).
// FMA contraction: none (see common.cuh).
#include "common.cuh"

namespace coconut {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kRowsPerWarp = 4;
constexpr int kQTile = 8;

__global__ void __launch_bounds__(kThreads)
euclid_cross_kernel(const float* __restrict__ queries,
                    const float* __restrict__ series, float* __restrict__ out,
                    int nq, long long n, int L) {
  extern __shared__ float smem[];
  float* s_q = smem;                        // [kQTile, L]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* s_x = smem + kQTile * L + warp * L;  // this warp's row slot
  const int q0 = blockIdx.y * kQTile;
  const int tq = min(kQTile, nq - q0);
  for (int i = threadIdx.x; i < tq * L; i += kThreads)
    s_q[i] = queries[static_cast<long long>(q0) * L + i];
  __syncthreads();
  const long long base =
      static_cast<long long>(blockIdx.x) * kWarps * kRowsPerWarp;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long row = base + r * kWarps + warp;
    if (row >= n) break;
    const float* x = series + row * L;
    for (int i = lane; i < L; i += kWarp) s_x[i] = x[i];
    __syncwarp();
    for (int qi = 0; qi < tq; ++qi) {
      const float d = ed_warp(s_x, s_q + qi * L, L, lane);
      if (lane == 0) out[static_cast<long long>(q0 + qi) * n + row] = d;
    }
    __syncwarp();
  }
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

// Cross form.  Requires nq >= 1, n >= 1, L >= 1, contiguous rows.
extern "C" int coconut_euclid_cross(const float* queries, const float* series,
                                    float* out, int nq, long long n, int L,
                                    void* stream) {
  using namespace coconut;
  const size_t smem = static_cast<size_t>(kQTile + kWarps) * L * sizeof(float);
  cudaError_t err = allow_smem(euclid_cross_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long rows_per_block = kWarps * kRowsPerWarp;
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>((nq + kQTile - 1) / kQTile));
  euclid_cross_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, series, out, nq, n, L);
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
