// Device routines shared by every Coconut kernel.
//
// FMA contraction: every float operation below is written with the
// round-to-nearest intrinsics (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn),
// which nvcc never contracts into a fused multiply-add.  The kernels thus
// perform the same IEEE float32 operations in the same order as the plain
// PyTorch twins in kernels/ref.py and agree with them bit for bit.  No source
// is compiled with --use_fast_math, and denormals are kept (no -ftz).
//
// The squared-ED routine is the only ED arithmetic on the card: the cross and
// gathered batch_euclid forms and scan_verify all call ed_warp, so one
// (query, row) pair has the same distance bits in every code path, for any
// batch size, tile or launch shape.
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
template <int W>
__device__ __forceinline__ float mindist_row(const int* c,
                                             const float* __restrict__ qpaa,
                                             const float* __restrict__ lower,
                                             const float* __restrict__ upper,
                                             int w, float scale) {
  const int n = W > 0 ? W : w;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const float q = qpaa[j];
    const float below = fmaxf(__fsub_rn(lower[c[j]], q), 0.f);
    const float above = fmaxf(__fsub_rn(q, upper[c[j]]), 0.f);
    const float d = __fadd_rn(below, above);
    acc = __fadd_rn(acc, __fmul_rn(d, d));
  }
  return __fmul_rn(scale, acc);
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace coconut
