// zorder: SAX codes [N, w] u8 -> z-order (invSAX) keys [N, n_words], each
// 32-bit word held in an int64 (the port's key layout, core/keys.py).
//
// Replaces the TPU kernel src/repro/kernels/zorder.py (zorder_pallas,
// pl.pallas_call at line 45): the paper's Algorithm 1, the second of the two
// construction stages, run by the external-sort bulk load, by tree.build
// given precomputed codes and by the seed probe's query keys.
//
// What bounds it on an H100: bytes.  Per row it reads w bytes of codes (16 B
// at w = 16) and writes 8 n_words bytes (32 B at 128 key bits); the bit
// permutation is a few integer operations per key bit.
//
// Design: one thread per row.  The thread loads its row's codes and builds
// each key word with zorder_word (common.cuh), the routine fused_build's key
// stage runs, so the two kernels agree bit for bit: global bit p = i * w + j
// (MSB first) is bit b - 1 - i of segment j, left-aligned in the last word.
// The TPU kernel's fully unrolled shift/or sequence over a lane tile becomes a
// per-thread loop; the output words of neighbouring threads are n_words apart,
// which the L2 merges into full lines.
#include "common.cuh"

namespace coconut {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
zorder_kernel(const uint8_t* __restrict__ codes, long long* __restrict__ keys,
              long long n, int w, int bits, int nw) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  int c[kMaxW];
  const uint8_t* src = codes + row * w;
  for (int j = 0; j < w; ++j) c[j] = src[j];
  for (int kw = 0; kw < nw; ++kw)
    keys[row * nw + kw] = static_cast<long long>(zorder_word(c, 1, kw, w, bits));
}

}  // namespace
}  // namespace coconut

// C entry point.  Returns a cudaError_t (0 on success).  Requires n >= 1,
// 1 <= w <= 64, 1 <= bits <= 8, nw = ceil(w * bits / 32); code values < 2^bits.
extern "C" int coconut_zorder(const uint8_t* codes, long long* keys, long long n,
                              int w, int bits, int nw, void* stream) {
  using namespace coconut;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  zorder_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, keys, n, w, bits, nw);
  return cudaGetLastError();
}
