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
// Keys: where w divides 32 (a warp holds 32 / w whole rows) or is a
// multiple of 32 (a row spans w / 32 warps), bit plane i of the codes (bit
// b - 1 - i of each) is one __ballot_sync over the warp's codes held lane
// by lane, and __brev with a shift puts the row's w bits MSB first at
// global key bit i * w (ballot_keys).  Other widths build each word with
// zorder_word from the tile's codes just written.  Both give zorder_word's
// bits, which the zorder kernel runs: sax_summarize + zorder ==
// fused_build.
#pragma once

#include "common.cuh"

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

// Is the key stage ballot_keys (else zorder_word) at width w?
__host__ __device__ constexpr bool ballot_width(int w) {
  return 32 % w == 0 || w % 32 == 0;
}

// The key words of the rows whose pairs a warp holds, from each lane's
// code.  p is the lane's pair in the tile (p % 32 is its lane); pairs at or
// past live_pairs are not in the tile and add no bit; keys points at the
// tile's first row.  Every lane of the warp calls it.  W = 0: w at run time.
template <int W>
__device__ __forceinline__ void ballot_keys(int code, int p, int live_pairs,
                                            int w_rt, int bits, int nw,
                                            long long* __restrict__ keys) {
  const int w = W > 0 ? W : w_rt;
  const int lane = threadIdx.x & (kWarp - 1);
  const bool live = p < live_pairs;
  // the code MSB first from bit 31: plane i is bit 31 - i
  const unsigned c = live ? static_cast<unsigned>(code) << (32 - bits) : 0u;
  if (w <= kWarp) {
    // the warp holds rows r0 .. r0 + 32 / w - 1; lane l builds word kw of
    // row r0 + g (l = g * nw + kw)
    const int r0 = (p - lane) / w;
    const int g = lane / nw;
    const int kw = lane - g * nw;
    const bool mine = g < kWarp / w;
    const int gw = mine ? g * w : 0;
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < kMaxBits; ++i) {
      if (i < bits) {
        const unsigned bal = __ballot_sync(kFull, (c >> (31 - i)) & 1u);
        const int bit0 = i * w;        // the plane's first global key bit
        if ((bit0 >> 5) == kw) {
          const unsigned f = (bal >> gw) & (kFull >> (kWarp - w));
          word |= (__brev(f) >> (kWarp - w)) << (kWarp - w - (bit0 & 31));
        }
      }
    }
    if (mine && (r0 + g) * w < live_pairs)
      keys[static_cast<long long>(r0 + g) * nw + kw] = word;
  } else {
    // a row spans w / 32 warps; this one holds segments 32 h .. 32 h + 31,
    // which are word i * w / 32 + h of plane i, MSB first
    const int r = p / w;
    const int h = (p - r * w) / kWarp;
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < kMaxBits; ++i) {
      if (i < bits) {
        const unsigned bal = __ballot_sync(kFull, (c >> (31 - i)) & 1u);
        if (lane == i) word = __brev(bal);
      }
    }
    if (live && lane < bits)
      keys[static_cast<long long>(r) * nw + lane * (w / kWarp) + h] = word;
  }
}

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
      ballot_keys<W>(code, tid, live_pairs, W, a.bits, a.nw,
                     a.keys + row0 * a.nw);
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
          ballot_keys<0>(code, p, live_pairs, w, a.bits, a.nw,
                         a.keys + row0 * a.nw);
      }
    }
    if constexpr (Tag::kKeys) {
      if (!ballot) {
        __syncthreads();    // the tile's codes, written above, are visible
        for (int q = threadIdx.x; q < tr * a.nw; q += kSumThreads) {
          const int r = q / a.nw;
          const int kw = q - r * a.nw;
          a.keys[(row0 + r) * a.nw + kw] = static_cast<long long>(
              zorder_word(a.codes + (row0 + r) * w, 1, kw, w, a.bits));
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
