// sax_summarize: raw series [N, L] f32 -> PAA [N, w] f32 and SAX codes [N, w]
// u8 (each code the count of breakpoints <= its PAA value).
//
// Replaces the TPU kernel src/repro/kernels/sax_summarize.py
// (sax_summarize_pallas, pl.pallas_call at line 47): the first of the two
// construction stages (summarize, then zorder) that the external-sort bulk
// load and the seed probe's query keys run.
//
// What bounds it on an H100: bytes.  It reads 4 L bytes per row (1 KiB at the
// paper's L = 256) and writes 5 w bytes (80 B); the work per byte is one add
// plus a few compares per segment.
//
// Design: the block body is summarize_tile (common.cuh), the same routine the
// fused_build kernel runs, so on the same rows the two kernels give the same
// PAA and code bits by construction.  A block stages a tile of whole rows in
// shared memory with coalesced loads (each segment padded by one float against
// bank conflicts); one thread per (row, segment) sums its segment in index
// order, divides by the segment length and finds the code by a binary search
// over the 2^b - 1 breakpoints held in shared memory.  The TPU kernel's
// compare-and-count over the whole breakpoint table (a dense vector reduction
// suited to the TPU) becomes that search: the same count, b compares.  The
// reference takes jnp.mean for the PAA, whose order XLA may change, so a PAA
// may differ from the reference's by an ulp (see fused_build.cu).
// FMA contraction: none (see common.cuh).
#include "common.cuh"

namespace coconut {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sax_summarize_kernel(const float* __restrict__ x, const float* __restrict__ bps,
                     float* __restrict__ paa, uint8_t* __restrict__ codes,
                     long long n, int L, int w, int bits, int rows) {
  extern __shared__ float smem[];
  const int card = 1 << bits;
  float* s_bps = smem;                  // [card - 1]
  float* s_x = s_bps + (card - 1);      // [rows, w, L / w + 1]
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int tr = static_cast<int>(min(static_cast<long long>(rows), n - row0));
  for (int i = threadIdx.x; i < card - 1; i += kThreads) s_bps[i] = bps[i];
  summarize_tile<kThreads>(x, s_bps, s_x, nullptr, row0, tr, L, w, card, paa,
                           codes);
}

}  // namespace
}  // namespace coconut

// C entry point.  Returns a cudaError_t (0 on success).  Requires n >= 1,
// L % w == 0, 1 <= bits <= 8, rows >= 1 with rows * (L + w) floats plus the
// breakpoints within shared memory.
extern "C" int coconut_sax_summarize(const float* x, const float* bps,
                                     float* paa, uint8_t* codes, long long n,
                                     int L, int w, int bits, int rows,
                                     void* stream) {
  using namespace coconut;
  const int sl = L / w;
  const size_t smem = (static_cast<size_t>((1 << bits) - 1) +
                       static_cast<size_t>(rows) * w * (sl + 1)) * sizeof(float);
  cudaError_t err = allow_smem(sax_summarize_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + rows - 1) / rows));
  sax_summarize_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, bps, paa, codes, n, L, w, bits, rows);
  return cudaGetLastError();
}
