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
// Design: the summarize tile (summarize_tile.cuh), which sax_summarize runs
// too, and its key stage.  A persistent grid of 256-thread blocks, one (row,
// segment) pair a thread; at the shipped shapes a thread loads its segment
// into registers as float4s and issues its next tile's loads before it sums
// the current one.  A thread sums its segment in index order and divides by the
// segment length (the order of the PAA in core/summarization.py), and finds
// its code by a branch-free binary search over the 2^b - 1 breakpoints (the
// count of breakpoints <= PAA, i.e. searchsorted side="right").  The key
// stage is key_stage.cuh's, which the zorder kernel runs too: at a width
// that is a power of two, bit plane i of a warp's codes is one ballot, and
// __brev puts a row's bits MSB first at global bit p = i * w + j (bit
// b - 1 - i of segment j).  The summation order differs from jnp.mean's only if XLA reorders
// it, so a PAA may differ from the reference's by an ulp and flip a code
// whose PAA lies within an ulp of a breakpoint.
// FMA contraction: none (see common.cuh).
#include "summarize_tile.cuh"

// C entry point.  Returns a cudaError_t (0 on success).  Requires n >= 1,
// L % w == 0, 1 <= bits <= 8, nw = ceil(w * bits / 32) and grid >= 1 (the
// wrapper's launch plan).
extern "C" int coconut_fused_build(const float* x, const float* bps, float* paa,
                                   uint8_t* codes, long long* keys, long long n,
                                   int L, int w, int bits, int nw, int grid,
                                   void* stream) {
  using namespace coconut;
  return summarize<FusedBuild>(
      SumArgs{x, bps, paa, codes, keys, n, L, w, bits, nw}, grid, stream);
}
