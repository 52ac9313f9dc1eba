// sax_summarize: raw series [N, L] f32 -> PAA [N, w] f32 and SAX codes [N, w]
// u8 (each code the count of breakpoints <= its PAA value).
//
// Replaces the TPU kernel src/repro/kernels/sax_summarize.py
// (sax_summarize_pallas, pl.pallas_call at line 47): the first of the two
// construction stages (summarize, then zorder) that the external-sort bulk
// load (one launch per 65,536-row chunk) and the seed probe's query keys run.
//
// What bounds it on an H100: bytes.  It reads 4 L bytes per row (1 KiB at the
// paper's L = 256) and writes 5 w bytes (80 B); the work per byte is one add
// plus a few compares per segment.
//
// Design: the summarize tile (summarize_tile.cuh) without its key stage, the
// tile fused_build runs, so on the same rows the two kernels give the same
// PAA and code bits by construction.  A persistent grid of 256-thread blocks,
// one (row, segment) pair a thread; at the shipped shapes a thread loads its
// segment into registers as float4s and issues its next tile's loads before
// it sums the current one.  The TPU kernel's compare-and-count over the whole
// breakpoint table (a dense vector reduction suited to the TPU) becomes a
// binary search: the same count, b compares.  The reference takes jnp.mean
// for the PAA, whose order XLA may change, so a PAA may differ from the
// reference's by an ulp (see fused_build.cu).
// FMA contraction: none (see common.cuh).
#include "summarize_tile.cuh"

// C entry point.  Returns a cudaError_t (0 on success).  Requires n >= 1,
// L % w == 0, 1 <= bits <= 8 and grid >= 1 (the wrapper's launch plan).
extern "C" int coconut_sax_summarize(const float* x, const float* bps,
                                     float* paa, uint8_t* codes, long long n,
                                     int L, int w, int bits, int grid,
                                     void* stream) {
  using namespace coconut;
  return summarize<SaxSummarize>(
      SumArgs{x, bps, paa, codes, nullptr, n, L, w, bits, 0}, grid, stream);
}
