// mindist_batch: batched squared iSAX lower bound, q_paas [Q, w] f32 x codes
// [N, w] u8 -> out [Q, N] f32.
//
// Replaces the TPU kernel src/repro/kernels/mindist_batch.py
// (mindist_batch_pallas, pl.pallas_call at line 70) and, at Q = 1, the
// single-query src/repro/kernels/mindist_scan.py (mindist_pallas, line 65).
//
// What bounds it on an H100.  The work is small: at the main path's shape
// (Q = 64, one 2000-row leaf, w = 16) the bytes it must move (32 KB of codes
// in, 512 KB of bound out) take 0.16 us at 3.35 TB/s and its 14.3 M FP32
// instructions (7w a pair) 0.43 us.  What held the first design far above
// that was latency and a quarter of the card: 256 rows and 16 queries a
// block gave 32 blocks on 132 SMs, and each thread walked 16 queries x 16
// segments as one dependent chain with two table loads a step.  The TPU
// kernel's one-hot region lookup (a gather-free trick for the TPU's vector
// unit) is gone: the region tables live in shared memory and are indexed
// directly.
//
// Design (bound_tile.cuh): a thread owns one row and a tile of up to 4
// queries; it reads its codes in place (one 16-byte load at w = 16, issued
// before the block fills its tables), looks up each segment's {lo, hi} pair
// once and adds the term to its queries' independent accumulators.  A block
// is 64 rows; the launch plan (kernels/mindist_batch.py:launch_plan) sizes
// the query tile so that the main path's launch has 512 blocks.  A block's
// static shared memory stays far within the default 48 KB.  What is left
// (measured on an H100): about 1 us of launch, one trip to memory and the
// stores, which the kernel pays at Q = 1 too, and the 64 queries' FP32
// terms at about half the card's issue rate.  FMA contraction: none (see
// common.cuh).
#include "bound_tile.cuh"

namespace coconut {
struct MindistBatch {};   // the kernel's name in a profile
}  // namespace coconut

// C entry point.  Returns a cudaError_t (0 on success).  Requires nq >= 1,
// n >= 1, 1 <= w <= 64, 1 <= card <= 256, codes rows contiguous, and the
// wrapper's launch plan: qt queries a block of 64 rows, and a (grid_x,
// grid_y) grid that covers every pair (launch_bound checks each).
extern "C" int coconut_mindist_batch(const float* q_paas, const uint8_t* codes,
                                     const float* lower, const float* upper,
                                     float* out, int nq, long long n, int w,
                                     int card, float scale, int qt, int grid_x,
                                     int grid_y, void* stream) {
  using namespace coconut;
  const BoundArgs a{q_paas, codes, lower, upper, out, nq, n, w, 8, w, card,
                    scale};
  return launch_bound<MindistBatch>(a, in_place_src(codes, w), qt, grid_x,
                                    grid_y, static_cast<cudaStream_t>(stream));
}
