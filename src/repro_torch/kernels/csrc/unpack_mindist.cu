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
// What bounds it on an H100: as mindist_batch, latency and filling the card,
// not bytes (at the paper's w = 16, b = 8 a row is 16 packed bytes in and
// Q floats of bound out).  The first design also staged the packed bytes
// with one-byte stores and read them at a row stride of 16 bytes, four lanes
// to a bank.
//
// Design: mindist_batch's bound tile (bound_tile.cuh), with the symbols
// found two ways.
//   * b = 8: a packed row is the code row byte for byte (symbol j is byte j:
//     the window at bit 8j is row[j]), so the rows are read in place exactly
//     as mindist_batch reads codes, with no staging.
//   * b < 8: the block copies its rows' packed bytes into shared memory in
//     4-byte words, each row at a stride of 15 words (odd, so a warp's 32
//     rows sit in 32 banks); a thread then extracts symbol j with
//     unpack_symbol (common.cuh): MSB first through the two-byte window at
//     bit j * b, reading zero instead of any byte past its row (the TPU
//     kernel padded one zero byte onto every row for this).
// Either way the bound is the same tile routine with the same region table
// and query PAAs, so packed == unpacked holds bit for bit by construction.
// FMA contraction: none (see common.cuh).
#include "bound_tile.cuh"

namespace coconut {
struct UnpackMindist {};   // the kernel's name in a profile
}  // namespace coconut

// C entry point.  Returns a cudaError_t (0 on success).  Requires nq >= 1,
// n >= 1, 1 <= w <= 64, 1 <= b <= 8, pw = ceil(w * b / 8), card = 2^b,
// packed rows contiguous, and the wrapper's launch plan as for
// coconut_mindist_batch.
extern "C" int coconut_unpack_mindist(const float* q_paas, const uint8_t* packed,
                                      const float* lower, const float* upper,
                                      float* out, int nq, long long n, int w,
                                      int b, int pw, int card, float scale,
                                      int qt, int grid_x, int grid_y,
                                      void* stream) {
  using namespace coconut;
  if (b < 1 || b > 8 || pw != (w * b + 7) / 8 || card != 1 << b)
    return cudaErrorInvalidValue;
  const BoundArgs a{q_paas, packed, lower, upper, out, nq, n, w, b, pw, card,
                    scale};
  const Src src = b == 8 ? in_place_src(packed, w) : Src::kStaged;
  return launch_bound<UnpackMindist>(a, src, qt, grid_x, grid_y,
                                     static_cast<cudaStream_t>(stream));
}
