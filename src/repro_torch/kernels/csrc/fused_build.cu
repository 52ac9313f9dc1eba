// fused_build: raw series [N, L] f32 -> PAA [N, w] f32, SAX codes [N, w] u8 and
// z-order keys [N, n_words] (32-bit words held in int64), in one pass.
//
// Replaces the TPU kernel src/repro/kernels/fused_build.py
// (fused_build_pallas, pl.pallas_call at line 57), which no reference entry
// point calls; here it is the Coconut-Tree build's summarization on the card.
//
// What bounds it on an H100: bytes.  It reads 4 L bytes per row (1 KiB at the
// paper's L = 256) and writes 4 w + w + 8 n_words bytes (112 B); the work per
// byte is one add plus a few compares per segment.
//
// Design: a block stages a tile of whole rows in shared memory with coalesced
// loads, padding each segment by one float so the threads that sum different
// segments hit different banks.  Then one thread per (row, segment) sums its
// segment in index order and divides by the segment length (the order of the
// PAA in core/summarization.py), and finds its code by a branch-free binary
// search over the 2^b - 1 breakpoints (the count of breakpoints <= PAA, i.e.
// searchsorted side="right") -- summarize_tile in common.cuh, which the
// sax_summarize kernel runs too.  Finally one thread per (row, key word)
// builds the word from the row's codes (zorder_word, shared with the zorder
// kernel): global bit p = i * w + j (MSB first) is bit b - 1 - i of segment j.
// The summation order differs from jnp.mean's only if XLA reorders it, so a
// PAA may differ from the reference's by an ulp and flip a code whose PAA lies
// within an ulp of a breakpoint.
// FMA contraction: none (see common.cuh).
#include "common.cuh"

namespace coconut {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_build_kernel(const float* __restrict__ x, const float* __restrict__ bps,
                   float* __restrict__ paa, uint8_t* __restrict__ codes,
                   long long* __restrict__ keys, long long n, int L, int w,
                   int bits, int nw, int rows) {
  extern __shared__ float smem[];
  const int card = 1 << bits;
  const int sl = L / w;
  float* s_bps = smem;                          // [card - 1]
  float* s_x = s_bps + (card - 1);              // [rows, w, sl + 1]
  int* s_codes = reinterpret_cast<int*>(s_x + rows * w * (sl + 1));  // [rows, w]
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int tr = static_cast<int>(min(static_cast<long long>(rows), n - row0));

  for (int i = threadIdx.x; i < card - 1; i += kThreads) s_bps[i] = bps[i];
  summarize_tile<kThreads>(x, s_bps, s_x, s_codes, row0, tr, L, w, card, paa,
                           codes);

  for (int t = threadIdx.x; t < tr * nw; t += kThreads) {
    const int r = t / nw;
    const int kw = t - r * nw;
    keys[(row0 + r) * nw + kw] =
        static_cast<long long>(zorder_word(s_codes + r * w, 1, kw, w, bits));
  }
}

}  // namespace
}  // namespace coconut

// C entry point.  Returns a cudaError_t (0 on success).  Requires n >= 1,
// L % w == 0, 1 <= bits <= 8, nw = ceil(w * bits / 32), rows >= 1 with
// rows * (L + 2 w) floats plus the breakpoints within shared memory.
extern "C" int coconut_fused_build(const float* x, const float* bps, float* paa,
                                   uint8_t* codes, long long* keys, long long n,
                                   int L, int w, int bits, int nw, int rows,
                                   void* stream) {
  using namespace coconut;
  const int sl = L / w;
  const size_t smem = (static_cast<size_t>((1 << bits) - 1) +
                       static_cast<size_t>(rows) * w * (sl + 1) +
                       static_cast<size_t>(rows) * w) * sizeof(float);
  cudaError_t err = allow_smem(fused_build_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + rows - 1) / rows));
  fused_build_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, bps, paa, codes, keys, n, L, w, bits, nw, rows);
  return cudaGetLastError();
}
