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

// SAX codes of row n into c[0..w): W > 0 is a compile-time width read with
// one vector load (16 bytes at W = 16, 8 at W = 8); W == 0 reads byte by byte.
template <int W>
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ codes,
                                           long long n, int w, int* c) {
  if constexpr (W == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes) + n);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) c[j] = (words[j >> 2] >> ((j & 3) * 8)) & 0xff;
  } else if constexpr (W == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(codes) + n);
    const uint32_t words[2] = {v.x, v.y};
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = (words[j >> 2] >> ((j & 3) * 8)) & 0xff;
  } else {
    const uint8_t* row = codes + n * w;
    for (int j = 0; j < w; ++j) c[j] = row[j];
  }
}

// Squared iSAX lower bound of one (query, row) pair: the w segment terms
// (max(lb - q, 0) + max(q - ub, 0))^2 added in index order, times L / w.
// lower/upper are the [2^b] region tables with -inf / +inf at the ends.
// The query's PAA is qpaa[j * stride] (a stride lets a kernel keep PAAs
// query-minor in shared memory, so a warp's lanes read adjacent words).
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
  for (int j = 0; j < n; ++j) {
    const float q = qpaa[j * stride];
    const float below = fmaxf(__fsub_rn(lower[c[j]], q), 0.f);
    const float above = fmaxf(__fsub_rn(q, upper[c[j]]), 0.f);
    const float d = __fadd_rn(below, above);
    acc = __fadd_rn(acc, __fmul_rn(d, d));
  }
  return __fmul_rn(scale, acc);
}

// PAA of one segment of sl floats: summed in index order, then divided by the
// segment length (the order of S.paa and the plain twins).  fused_build and
// sax_summarize both call this, so their PAAs agree bit for bit.
__device__ __forceinline__ float paa_segment(const float* seg, int sl) {
  float acc = 0.f;
  for (int e = 0; e < sl; ++e) acc = __fadd_rn(acc, seg[e]);
  return __fdiv_rn(acc, static_cast<float>(sl));
}

// SAX code of one PAA value: the count of the card - 1 ascending breakpoints
// that are <= v (searchsorted side="right"), by a branch-free binary search.
__device__ __forceinline__ int sax_code(float v, const float* bps, int card) {
  int pos = 0;
  for (int step = card >> 1; step > 0; step >>= 1)
    if (bps[pos + step - 1] <= v) pos += step;
  return pos;
}

// Word kw of a row's z-order key from its w codes: global bit p = i * w + j
// (MSB first) is bit bits - 1 - i of segment j; a last word the w * bits bits
// do not fill is left-aligned.  Codes are read as c[j * stride].
__device__ __forceinline__ unsigned zorder_word(const int* c, int stride, int kw,
                                                int w, int bits) {
  const int total = w * bits;
  unsigned word = 0;
  for (int b = 0; b < 32; ++b) {
    const int p = kw * 32 + b;
    if (p >= total) break;
    const int i = p / w;
    const int j = p - i * w;
    word |= ((static_cast<unsigned>(c[j * stride]) >> (bits - 1 - i)) & 1u)
            << (31 - b);
  }
  return word;
}

// The w symbols of one bit-packed code row of pw bytes: symbol j sits MSB
// first at bit j * b and is read through the two-byte window at byte
// j * b / 8.  A window that would reach past the row reads a zero byte there,
// so no byte of the next row (or past the array) is ever read.
template <int W>
__device__ __forceinline__ void unpack_row(const uint8_t* row, int w, int b,
                                           int pw, int* c) {
  const int n = W > 0 ? W : w;
  const int mask = (1 << b) - 1;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const int bit = j * b;
    const int bl = bit >> 3;
    const int hi = row[bl];
    const int lo = bl + 1 < pw ? row[bl + 1] : 0;
    c[j] = (((hi << 8) | lo) >> (16 - (bit & 7) - b)) & mask;
  }
}

// Summarize a tile of tr rows starting at row0 (the construction pass shared
// by fused_build and sax_summarize).  The block stages the rows in shared
// memory with coalesced loads, padding each segment by one float so threads
// summing different segments hit different banks (s_x holds tr * w * (sl + 1)
// floats), then one thread per (row, segment) writes the PAA and the SAX code
// (and keeps the code in s_codes when it is given).  s_bps must be filled
// before the call; the call ends with __syncthreads().  THREADS is the block
// size: a compile-time stride lets nvcc unroll the staging loop and keep
// several loads in flight per thread.
template <int THREADS>
__device__ __forceinline__ void summarize_tile(
    const float* __restrict__ x, const float* s_bps, float* s_x, int* s_codes,
    long long row0, int tr, int L, int w, int card, float* __restrict__ paa,
    uint8_t* __restrict__ codes) {
  const int sl = L / w;
  const float* src = x + row0 * L;
  for (int i = threadIdx.x; i < tr * L; i += THREADS) {
    const int r = i / L;
    const int l = i - r * L;
    const int s = l / sl;
    s_x[(r * w + s) * (sl + 1) + (l - s * sl)] = src[i];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < tr * w; p += THREADS) {
    const float v = paa_segment(s_x + p * (sl + 1), sl);
    const int code = sax_code(v, s_bps, card);
    paa[row0 * w + p] = v;
    codes[row0 * w + p] = static_cast<uint8_t>(code);
    if (s_codes != nullptr) s_codes[p] = code;
  }
  __syncthreads();
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace coconut
