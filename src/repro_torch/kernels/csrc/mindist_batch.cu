// mindist_batch: batched squared iSAX lower bound, q_paas [Q, w] f32 x codes
// [N, w] u8 -> out [Q, N] f32.
//
// Replaces the TPU kernel src/repro/kernels/mindist_batch.py
// (mindist_batch_pallas, pl.pallas_call at line 70) and, at Q = 1, the
// single-query src/repro/kernels/mindist_scan.py (mindist_pallas, line 65).
//
// What bounds it on an H100: bytes.  Per row it reads w bytes of codes (16 B at
// the paper's w = 16) and writes Q floats of bound (256 B at Q = 64), so the
// output dominates; the arithmetic is ~7 flops per (pair, segment).  The TPU
// kernel's one-hot region lookup (a gather-free trick for the TPU's vector
// unit) is gone: the two [2^b] region tables (2 KB at b = 8) and the block's
// query PAAs live in shared memory and are indexed directly.
//
// Design: one thread per row, 256 rows per block; blockIdx.y tiles the queries
// (kQTile per block).  A thread loads its row's codes once (one 16-byte load at
// w = 16, straight from the tree's uint8 column) and loops over the block's
// queries, so each store of a query's row of output is coalesced across the
// warp.  FMA contraction: none (see common.cuh).
#include "common.cuh"

namespace coconut {
namespace {

constexpr int kRows = 256;
constexpr int kQTile = 16;

template <int W>
__global__ void __launch_bounds__(kRows)
mindist_batch_kernel(const float* __restrict__ q_paas,
                     const uint8_t* __restrict__ codes,
                     const float* __restrict__ lower,
                     const float* __restrict__ upper, float* __restrict__ out,
                     int nq, long long n, int w, int card, float scale) {
  extern __shared__ float smem[];
  float* s_lo = smem;
  float* s_hi = s_lo + card;
  float* s_q = s_hi + card;
  const int q0 = blockIdx.y * kQTile;
  const int tq = min(kQTile, nq - q0);
  for (int i = threadIdx.x; i < card; i += blockDim.x) {
    s_lo[i] = lower[i];
    s_hi[i] = upper[i];
  }
  for (int i = threadIdx.x; i < tq * w; i += blockDim.x)
    s_q[i] = q_paas[static_cast<long long>(q0) * w + i];
  __syncthreads();
  const long long row = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x;
  if (row >= n) return;
  int c[W > 0 ? W : kMaxW];
  load_codes<W>(codes, row, w, c);
  for (int qi = 0; qi < tq; ++qi)
    out[static_cast<long long>(q0 + qi) * n + row] =
        mindist_row<W>(c, s_q + qi * w, s_lo, s_hi, w, scale);
}

template <int W>
cudaError_t launch(const float* q_paas, const uint8_t* codes, const float* lower,
                   const float* upper, float* out, int nq, long long n, int w,
                   int card, float scale, cudaStream_t stream) {
  const size_t smem = (2 * card + kQTile * w) * sizeof(float);
  cudaError_t err = allow_smem(mindist_batch_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows),
                  static_cast<unsigned>((nq + kQTile - 1) / kQTile));
  mindist_batch_kernel<W><<<grid, kRows, smem, stream>>>(
      q_paas, codes, lower, upper, out, nq, n, w, card, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace coconut

// C entry point.  Returns a cudaError_t (0 on success).  Requires nq >= 1,
// n >= 1, 1 <= w <= 64; codes rows contiguous.
extern "C" int coconut_mindist_batch(const float* q_paas, const uint8_t* codes,
                                     const float* lower, const float* upper,
                                     float* out, int nq, long long n, int w,
                                     int card, float scale, void* stream) {
  using namespace coconut;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t p = reinterpret_cast<uintptr_t>(codes);
  if (w == 16 && p % 16 == 0)
    return launch<16>(q_paas, codes, lower, upper, out, nq, n, w, card, scale, s);
  if (w == 8 && p % 8 == 0)
    return launch<8>(q_paas, codes, lower, upper, out, nq, n, w, card, scale, s);
  return launch<0>(q_paas, codes, lower, upper, out, nq, n, w, card, scale, s);
}
