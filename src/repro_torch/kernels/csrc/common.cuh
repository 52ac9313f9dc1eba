// Device routines shared by every Coconut kernel.
//
// FMA contraction: every float operation below is written with the
// round-to-nearest intrinsics (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn),
// which nvcc never contracts into a fused multiply-add.  The kernels thus
// perform the same IEEE float32 operations in the same order as the plain
// PyTorch twins in kernels/ref.py and agree with them bit for bit.  No source
// is compiled with --use_fast_math, and denormals are kept (no -ftz).
//
// ed_warp defines the squared-ED order on the card: the gathered
// batch_euclid form and scan_verify call it, and the register-tiled cross
// form (batch_euclid.cu) forms the same lane partials and folds them in the
// same tree, so one (query, row) pair has the same distance bits in every
// code path, for any batch size, tile or launch shape.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace coconut {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxW = 64;   // widest SAX word the kernels take
constexpr int kMaxBits = 8; // widest SAX symbol

// Squared ED of one (query, row) pair, computed by a whole warp.  Lane l sums
// (x[i] - q[i])^2 for i = l, l + 32, ... in order; the 32 partials are then
// folded in halves (a butterfly, so every lane ends with the same value).
// The loads of kEdUnroll strided elements are issued together before their
// squares are added (still in index order), so a row read from device memory
// costs one round trip per kEdUnroll elements, not one per element.
constexpr int kEdUnroll = 8;

__device__ __forceinline__ float ed_warp(const float* __restrict__ x,
                                         const float* __restrict__ q,
                                         int L, int lane) {
  float acc = 0.f;
  int i = lane;
  for (; i + (kEdUnroll - 1) * kWarp < L; i += kEdUnroll * kWarp) {
    float d[kEdUnroll];
#pragma unroll
    for (int u = 0; u < kEdUnroll; ++u)
      d[u] = __fsub_rn(x[i + u * kWarp], q[i + u * kWarp]);
#pragma unroll
    for (int u = 0; u < kEdUnroll; ++u) acc = __fadd_rn(acc, __fmul_rn(d[u], d[u]));
  }
  for (; i < L; i += kWarp) {
    const float d = __fsub_rn(x[i], q[i]);
    acc = __fadd_rn(acc, __fmul_rn(d, d));
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  return acc;
}

// One segment's term of the squared iSAX lower bound, added onto acc:
// (max(lo - q, 0) + max(q - hi, 0))^2, one rounding per operation.  Every
// bound on the card (mindist_row, the bound tile of mindist_batch and
// unpack_mindist, and through mindist_row scan_verify's) adds its terms with
// this routine, in index order, so they agree bit for bit by construction.
__device__ __forceinline__ float mindist_term(float acc, float q, float lo,
                                              float hi) {
  const float below = fmaxf(__fsub_rn(lo, q), 0.f);
  const float above = fmaxf(__fsub_rn(q, hi), 0.f);
  const float d = __fadd_rn(below, above);
  return __fadd_rn(acc, __fmul_rn(d, d));
}

// Squared iSAX lower bound of one (query, row) pair: the w segment terms
// added in index order, times L / w.  lower/upper are the [2^b] region
// tables with -inf / +inf at the ends.  The query's PAA is qpaa[j * stride]
// (a stride lets a kernel keep PAAs query-minor in shared memory, so a
// warp's lanes read adjacent words).
template <int W>
__device__ __forceinline__ float mindist_row(const int* c,
                                             const float* __restrict__ qpaa,
                                             const float* __restrict__ lower,
                                             const float* __restrict__ upper,
                                             int w, float scale,
                                             int stride = 1) {
  const int n = W > 0 ? W : w;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < n; ++j)
    acc = mindist_term(acc, qpaa[j * stride], lower[c[j]], upper[c[j]]);
  return __fmul_rn(scale, acc);
}

// SAX code of one PAA value: the count of the 2^bits - 1 ascending
// breakpoints that are <= v (searchsorted side="right"), by a branch-free
// binary search, unrolled over the at most kMaxBits steps.
__device__ __forceinline__ int sax_code(float v, const float* bps, int bits) {
  int pos = 0;
#pragma unroll
  for (int k = kMaxBits - 1; k >= 0; --k)
    if (k < bits && bps[pos + (1 << k) - 1] <= v) pos += 1 << k;
  return pos;
}

// Symbol j of a bit-packed code row of pw bytes whose byte m is byte(m):
// it sits MSB first at bit j * b and is read through the two-byte window at
// byte j * b / 8.  A window that would reach past the row reads a zero byte
// there, so no byte of the next row (or past the array) is ever read.
template <typename Byte>
__device__ __forceinline__ int unpack_symbol(Byte byte, int j, int b, int pw) {
  const int bit = j * b;
  const int bl = bit >> 3;
  const int hi = byte(bl);
  const int lo = bl + 1 < pw ? byte(bl + 1) : 0;
  return (((hi << 8) | lo) >> (16 - (bit & 7) - b)) & ((1 << b) - 1);
}

// The error of a refused runtime call, cleared from CUDA's last error: every
// entry point ends in cudaGetLastError(), so an error left set would make the
// next call of any kernel in the library fail.
inline cudaError_t refused(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace coconut
