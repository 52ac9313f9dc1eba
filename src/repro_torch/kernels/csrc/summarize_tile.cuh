// The summarize tile of sax_summarize.cu and fused_build.cu: raw series
// [N, L] f32 -> PAA [N, w] f32 and SAX codes [N, w] u8 (each code the count
// of breakpoints <= its PAA), and for fused_build also the z-order keys
// [N, nw] (32-bit words held in int64).
//
// Layout of a launch: a block is kSumThreads threads, one (row, segment)
// pair each, pairs row-major (thread p holds segment p % w of row p / w), so
// a tile is kSumThreads / w whole rows.  The grid is persistent: the
// wrapper's launch plan (kernels/sax_summarize.py) sizes it to the card,
// and block b walks tiles b, b + grid, ...
//
// The tile at the shapes the repo ships, (L, w) = (256, 16) and (64, 8),
// with x 16-byte aligned: the segment length SL and w are compile-time
// constants, so no index needs a division.  A thread loads its segment
// straight into registers as SL / 4 float4s (a warp's loads cover 32 whole
// segments, 2 KiB at SL = 16, each 32-byte sector read whole by two loads
// that meet in L1), and issues the loads of its next tile before it sums
// the current one, so a block's loads overlap its own compute.  Shared
// memory holds the breakpoints only.  (A variant that copied each tile into
// shared memory with 16-byte cp.async copies, two buffers, at a
// bank-conflict-free stride, was 15% slower at the tree build: PERF.md.)
//
// Every other L % w == 0, or x not 16-byte aligned: the generic tile, with
// the same pairs and the same order; a thread reads its segment from device
// memory one float at a time.
//
// Arithmetic, the same in both: the segment summed in index order from its
// first float, then __fdiv_rn by its length (the order of S.paa and the
// plain twins); the code by sax_code's binary search over the breakpoints.
// So both tiles, and both kernels, give the same bits.
//
// Keys: the key stage of key_stage.cuh, which the zorder kernel runs too,
// so sax_summarize + zorder == fused_build.  Where w is a power of two, each
// lane's code goes straight from registers into ballot_keys (the tile's
// pairs are its layout); at every other width, once the tile's codes are
// written, thread r builds row r's key with row_key from them.
#pragma once

#include "key_stage.cuh"

namespace coconut {

constexpr int kSumThreads = 256;     // (row, segment) pairs a block
constexpr int kSumBlocksPerSm = 4;   // resident blocks an SM (the plan's grid)
constexpr int kMaxBps = 255;         // breakpoints at b = 8

struct SumArgs {
  const float* x;      // [n, L]
  const float* bps;    // [2^bits - 1] ascending
  float* paa;          // [n, w]
  uint8_t* codes;      // [n, w]
  long long* keys;     // [n, nw]; fused_build only
  long long n;
  int L, w, bits, nw;
};

// Entry-point tags: the kernel's profiler name carries its entry point.
struct SaxSummarize {
  static constexpr bool kKeys = false;
};
struct FusedBuild {
  static constexpr bool kKeys = true;
};

// The tile at a compile-time shape: SL floats a segment, W segments a row.
template <typename Tag, int SL, int W>
__device__ __forceinline__ void shaped_tiles(const SumArgs& a,
                                             const float* s_bps) {
  static_assert(SL % 4 == 0 && kSumThreads % W == 0 && ballot_width(W),
                "a segment is whole float4s, a tile whole rows of whole "
                "warps, and the keys ballots");
  constexpr int kRows = kSumThreads / W;   // rows a tile
  constexpr int kVecs = SL / 4;            // float4s a segment
  const int tid = threadIdx.x;
  const long long tiles = (a.n + kRows - 1) / kRows;
  const auto load = [&](long long t, float4 (&f)[kVecs]) {
    const long long pair = t * kSumThreads + tid;   // = row * W + segment
    if (pair < a.n * W) {
      const float4* src = reinterpret_cast<const float4*>(a.x + pair * SL);
#pragma unroll
      for (int k = 0; k < kVecs; ++k) f[k] = __ldg(src + k);
    }
  };
  KeyLane kl{};
  if constexpr (Tag::kKeys) kl = key_lane(W, a.nw);
  float4 cur[kVecs], next[kVecs];
  long long t = blockIdx.x;
  if (t < tiles) load(t, cur);
  for (; t < tiles; t += gridDim.x) {
    if (t + gridDim.x < tiles) load(t + gridDim.x, next);
    const long long row0 = t * kRows;
    const int live_pairs =
        static_cast<int>(min(static_cast<long long>(kRows), a.n - row0)) * W;
    float acc = cur[0].x;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      if (k > 0) acc = __fadd_rn(acc, cur[k].x);
      acc = __fadd_rn(acc, cur[k].y);
      acc = __fadd_rn(acc, cur[k].z);
      acc = __fadd_rn(acc, cur[k].w);
    }
    const float m = __fdiv_rn(acc, static_cast<float>(SL));
    const int code = sax_code(m, s_bps, a.bits);
    if (tid < live_pairs) {
      a.paa[row0 * W + tid] = m;
      a.codes[row0 * W + tid] = static_cast<uint8_t>(code);
    }
    if constexpr (Tag::kKeys)
      ballot_keys<W>(kl, tid < live_pairs ? code : 0, tid, live_pairs,
                     a.bits, a.nw, a.keys + row0 * a.nw);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) cur[k] = next[k];
  }
}

template <typename Tag>
__device__ __forceinline__ void generic_tiles(const SumArgs& a,
                                              const float* s_bps) {
  const int w = a.w;
  const int sl = a.L / w;
  const int rows = w <= kSumThreads ? kSumThreads / w : 1;
  const long long tiles = (a.n + rows - 1) / rows;
  const bool ballot = ballot_width(w);
  KeyLane kl{};
  if constexpr (Tag::kKeys) {
    if (ballot) kl = key_lane(w, a.nw);
  }
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * rows;
    const int tr = static_cast<int>(min(static_cast<long long>(rows),
                                        a.n - row0));
    const int live_pairs = tr * w;
    // every thread runs the same steps, so each warp's ballots are whole
    for (int p0 = 0; p0 < rows * w; p0 += kSumThreads) {
      const int p = p0 + threadIdx.x;
      int code = 0;
      if (p < live_pairs) {
        const int r = p / w;
        const float* seg = a.x + (row0 + r) * a.L + (p - r * w) * sl;
        float acc = seg[0];
        for (int e = 1; e < sl; ++e) acc = __fadd_rn(acc, seg[e]);
        const float m = __fdiv_rn(acc, static_cast<float>(sl));
        code = sax_code(m, s_bps, a.bits);
        a.paa[row0 * w + p] = m;
        a.codes[row0 * w + p] = static_cast<uint8_t>(code);
      }
      if constexpr (Tag::kKeys) {
        if (ballot)
          ballot_keys<0>(kl, code, p, live_pairs, a.bits, a.nw,
                         a.keys + row0 * a.nw);
      }
    }
    if constexpr (Tag::kKeys) {
      if (!ballot) {
        __syncthreads();    // the tile's codes, written above, are visible
        for (int r = threadIdx.x; r < tr; r += kSumThreads) {
          const uint8_t* row = a.codes + (row0 + r) * w;
          long long* key = a.keys + (row0 + r) * a.nw;
          const auto code4 = [&](int j) {
            unsigned x = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j + e < w) x |= static_cast<unsigned>(row[j + e]) << (8 * e);
            return x;
          };
          const auto store = [&](int kw, unsigned word) { key[kw] = word; };
          if (w <= kMaxW)
            row_key<false>(code4, w, a.bits, store);
          else
            row_key<true>(code4, w, a.bits, store);
        }
      }
    }
  }
}

// SL = W = 0: the generic tile.
template <typename Tag, int SL, int W>
__global__ void __launch_bounds__(kSumThreads, kSumBlocksPerSm)
summarize_kernel(SumArgs a) {
  __shared__ float s_bps[kMaxBps];
  for (int i = threadIdx.x; i < (1 << a.bits) - 1; i += kSumThreads)
    s_bps[i] = a.bps[i];
  __syncthreads();
  if constexpr (SL > 0)
    shaped_tiles<Tag, SL, W>(a, s_bps);
  else
    generic_tiles<Tag>(a, s_bps);
}

// One launch of grid blocks.  Requires n >= 1, L % w == 0, 1 <= bits <= 8,
// grid >= 1 and, for keys, nw = ceil(w * bits / 32).
template <typename Tag>
inline cudaError_t summarize(const SumArgs& a, int grid, void* stream) {
  if (a.n < 1 || a.w < 1 || a.L % a.w != 0 || a.bits < 1 ||
      a.bits > kMaxBits || grid < 1 ||
      (Tag::kKeys && a.nw != (a.w * a.bits + 31) / 32))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  if (vec && a.L == 256 && a.w == 16)
    summarize_kernel<Tag, 16, 16><<<grid, kSumThreads, 0, s>>>(a);
  else if (vec && a.L == 64 && a.w == 8)
    summarize_kernel<Tag, 8, 8><<<grid, kSumThreads, 0, s>>>(a);
  else
    summarize_kernel<Tag, 0, 0><<<grid, kSumThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace coconut
