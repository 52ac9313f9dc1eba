// unpack_mindist: batched squared iSAX lower bound over bit-packed code rows,
// q_paas [Q, w] f32 x packed [N, ceil(w * b / 8)] u8 -> out [Q, N] f32,
// bit-equal to mindist_batch on the decoded codes.
//
// Replaces the TPU kernel src/repro/kernels/unpack_mindist.py
// (unpack_mindist_batch_pallas, pl.pallas_call at line 83): the lower bound
// of every leaf group the executor scans off a format-v3 segment, whether the
// rows were read from the mmap and copied over or come from the tiered
// store's device-resident blocks.
//
// What bounds it on an H100: bytes.  Per row it reads ceil(w b / 8) packed
// bytes (16 B at the paper's w = 16, b = 8) and writes Q floats of bound
// (256 B at Q = 64), so the output dominates, as in mindist_batch.
//
// Design: mindist_batch's, with the unpack in front.  One thread per row, 256
// rows per block, blockIdx.y tiles the queries.  The block first copies its
// rows' packed bytes (one contiguous range) into shared memory with coalesced
// loads; each thread then extracts its w symbols with unpack_row (common.cuh):
// symbol j is read MSB first through the two-byte window at bit j * b, and a
// window that would reach past the row reads zero there instead of the next
// row's byte (the TPU kernel padded one zero byte onto every row for this).
// The bound itself is mindist_row, the routine mindist_batch runs, with the
// same region tables and query PAAs in shared memory and the same summation
// order, so packed == unpacked holds bit for bit by construction.
// FMA contraction: none (see common.cuh).
#include "common.cuh"

namespace coconut {
namespace {

constexpr int kRows = 256;
constexpr int kQTile = 16;

template <int W>
__global__ void __launch_bounds__(kRows)
unpack_mindist_kernel(const float* __restrict__ q_paas,
                      const uint8_t* __restrict__ packed,
                      const float* __restrict__ lower,
                      const float* __restrict__ upper, float* __restrict__ out,
                      int nq, long long n, int w, int b, int pw, int card,
                      float scale) {
  extern __shared__ float smem[];
  float* s_lo = smem;
  float* s_hi = s_lo + card;
  float* s_q = s_hi + card;
  uint8_t* s_pk = reinterpret_cast<uint8_t*>(s_q + kQTile * w);  // [kRows, pw]
  const int q0 = blockIdx.y * kQTile;
  const int tq = min(kQTile, nq - q0);
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int tr = static_cast<int>(min(static_cast<long long>(kRows), n - row0));
  for (int i = threadIdx.x; i < card; i += blockDim.x) {
    s_lo[i] = lower[i];
    s_hi[i] = upper[i];
  }
  for (int i = threadIdx.x; i < tq * w; i += blockDim.x)
    s_q[i] = q_paas[static_cast<long long>(q0) * w + i];
  const uint8_t* src = packed + row0 * pw;
  for (int i = threadIdx.x; i < tr * pw; i += blockDim.x) s_pk[i] = src[i];
  __syncthreads();
  if (threadIdx.x >= tr) return;
  const long long row = row0 + threadIdx.x;
  int c[W > 0 ? W : kMaxW];
  unpack_row<W>(s_pk + threadIdx.x * pw, w, b, pw, c);
  for (int qi = 0; qi < tq; ++qi)
    out[static_cast<long long>(q0 + qi) * n + row] =
        mindist_row<W>(c, s_q + qi * w, s_lo, s_hi, w, scale);
}

template <int W>
cudaError_t launch(const float* q_paas, const uint8_t* packed,
                   const float* lower, const float* upper, float* out, int nq,
                   long long n, int w, int b, int pw, int card, float scale,
                   cudaStream_t stream) {
  const size_t smem = (2 * card + kQTile * w) * sizeof(float) +
                      static_cast<size_t>(kRows) * pw;
  cudaError_t err = allow_smem(unpack_mindist_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows),
                  static_cast<unsigned>((nq + kQTile - 1) / kQTile));
  unpack_mindist_kernel<W><<<grid, kRows, smem, stream>>>(
      q_paas, packed, lower, upper, out, nq, n, w, b, pw, card, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace coconut

// C entry point.  Returns a cudaError_t (0 on success).  Requires nq >= 1,
// n >= 1, 1 <= w <= 64, 1 <= b <= 8, pw = ceil(w * b / 8), card = 2^b; packed
// rows contiguous.
extern "C" int coconut_unpack_mindist(const float* q_paas, const uint8_t* packed,
                                      const float* lower, const float* upper,
                                      float* out, int nq, long long n, int w,
                                      int b, int pw, int card, float scale,
                                      void* stream) {
  using namespace coconut;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 16)
    return launch<16>(q_paas, packed, lower, upper, out, nq, n, w, b, pw, card,
                      scale, s);
  return launch<0>(q_paas, packed, lower, upper, out, nq, n, w, b, pw, card,
                   scale, s);
}
