// The bound tile of mindist_batch.cu and unpack_mindist.cu: the squared iSAX
// lower bound of every (query, row) pair of a launch, q_paas [Q, w] f32 x a
// row's w symbols -> out [Q, N] f32.
//
// Layout of a launch: a block is kRows threads, one row each, and a tile of
// QT queries that every thread of the block computes, so a block covers
// kRows x QT pairs and the grid (row tiles, query tiles) covers every pair
// once.  The wrapper's launch plan (kernels/mindist_batch.py) picks QT and
// the grid.  Lanes run along the rows, so each of a thread's QT stores is
// coalesced across its warp.
//
// A thread reads a symbol once per segment, looks up its region pair
// {lo, hi} with one 8-byte shared load, and adds that segment's term to its
// QT queries' accumulators: QT independent chains, unrolled, in place of one
// chain QT times as long.  Each pair still adds its w terms in index order
// with mindist_term (common.cuh) and is scaled last, so no tile, layout or
// source changes a bit.
//
// Shared memory, static and sized for the widest word (at most 6912 B, far
// below the 48 KB a block has without cudaFuncSetAttribute): the [256]
// float2 region table, the block's query PAAs query-minor ([w][QT]: a
// segment's QT values are one or two vector loads, the same address across
// the block), and for Src::kStaged the block's packed rows at a stride of
// kStageStride words, an odd number, so the 32 lanes of a warp read 32
// different banks.
#pragma once

#include "common.cuh"

namespace coconut {

constexpr int kTabEntries = 256;       // 2^b region pairs, b <= 8
constexpr int kRows = 64;              // rows (threads) per block, two warps
constexpr int kMaxQT = 4;              // queries per thread
// staged packed row stride in 4-byte words: odd, and holds the widest
// packed row that is staged (w = 64 at b = 7: 56 bytes)
constexpr int kStageStride = 15;
static_assert(kStageStride % 2 == 1 && 4 * kStageStride >= (kMaxW * 7 + 7) / 8,
              "a staged row must fit its stride, and the stride be odd");
static_assert(kTabEntries * 8 + kMaxW * kMaxQT * 4 + kRows * kStageStride * 4
                  <= 48 * 1024,
              "the bound tile must fit the default shared memory");

// Where a thread reads its row's symbols.
enum class Src {
  kBytes,   // one byte a symbol, read in place byte by byte
  kVec16,   // one byte a symbol, in place, 16 at a time (w % 16 == 0, aligned)
  kStaged,  // bit-packed (b < 8), staged in shared memory, then unpacked
};

struct BoundArgs {
  const float* q_paas;   // [nq, w]
  const uint8_t* rows;   // codes [n, w] or packed rows [n, pw]
  const float* lower;    // [card] region tables, -inf / +inf at the ends
  const float* upper;
  float* out;            // [nq, n]
  int nq;
  long long n;
  int w, b, pw, card;
  float scale;
};

// The 4 bytes at p, little-endian, from aligned words (two when p is not
// aligned).  p lies before end; the second word is read only when it starts
// before end, so no word past the array's last one is touched.
__device__ __forceinline__ uint32_t load_word(const uint8_t* p,
                                              const uint8_t* end) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w0 = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t{3});
  const int sh = static_cast<int>(addr & 3);
  const uint32_t lo = __ldg(w0);
  if (sh == 0) return lo;
  const uint32_t hi =
      reinterpret_cast<const uint8_t*>(w0 + 1) < end ? __ldg(w0 + 1) : 0u;
  return __funnelshift_r(lo, hi, 8 * sh);
}

// Segment j's term for a thread's QT queries (their PAAs at qj[0..QT)).
template <int QT>
__device__ __forceinline__ void add_segment(float (&acc)[QT], float2 t,
                                            const float* qj) {
  float q[QT];
  if constexpr (QT % 4 == 0) {
#pragma unroll
    for (int v = 0; v < QT / 4; ++v) {
      const float4 f = reinterpret_cast<const float4*>(qj)[v];
      q[4 * v] = f.x;
      q[4 * v + 1] = f.y;
      q[4 * v + 2] = f.z;
      q[4 * v + 3] = f.w;
    }
  } else if constexpr (QT == 2) {
    const float2 f = *reinterpret_cast<const float2*>(qj);
    q[0] = f.x;
    q[1] = f.y;
  } else {
    q[0] = qj[0];
  }
#pragma unroll
  for (int i = 0; i < QT; ++i) acc[i] = mindist_term(acc[i], q[i], t.x, t.y);
}

// Tag names the entry point that launches the kernel (its profiler name).
template <typename Tag, int QT, Src S>
__global__ void __launch_bounds__(kRows) bound_kernel(BoundArgs a) {
  constexpr bool kStaged = S == Src::kStaged;
  __shared__ float2 s_tab[kTabEntries];
  __shared__ __align__(16) float s_q[kMaxW * QT];
  __shared__ uint32_t s_pk[kStaged ? kRows * kStageStride : 1];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * QT;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long row = row0 + threadIdx.x;
  const bool live = row < a.n;
  const uint8_t* src = a.rows + row * a.w;   // in-place sources only

  // the row's first 16 symbols, requested before the fills so that the
  // trips to memory overlap
  uint4 cur{};
  if constexpr (S == Src::kVec16) {
    if (live) cur = __ldg(reinterpret_cast<const uint4*>(src));
  }
  // the fills: every read is issued before any shared store, so a block
  // waits for one trip to memory rather than one per loop step (a thread
  // holds at most kTabPer table entries and kQPer PAAs)
  constexpr int kTabPer = kTabEntries / kRows;
  constexpr int kQPer = QT * kMaxW / kRows;
  float2 tab[kTabPer];
#pragma unroll
  for (int u = 0; u < kTabPer; ++u) {
    const int i = tid + u * kRows;
    if (i < a.card)
      tab[u] = make_float2(__ldg(a.lower + i), __ldg(a.upper + i));
  }
  // PAAs read in their global order (coalesced), stored query-minor; the
  // queries past nq get zeros and are never stored
  const int nqb = min(QT, a.nq - q0);
  const float* qsrc = a.q_paas + static_cast<long long>(q0) * a.w;
  float qv[kQPer];
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int i = tid + u * kRows;
    qv[u] = i < nqb * a.w ? __ldg(qsrc + i) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kTabPer; ++u) {
    const int i = tid + u * kRows;
    if (i < a.card) s_tab[i] = tab[u];
  }
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int i = tid + u * kRows;
    if (i < QT * a.w) {
      const int k = i / a.w;
      s_q[(i - k * a.w) * QT + k] = qv[u];
    }
  }
  if constexpr (kStaged) {
    const int tr = static_cast<int>(min(static_cast<long long>(kRows),
                                        a.n - row0));
    const int wpr = (a.pw + 3) >> 2;
    const uint8_t* base = a.rows + row0 * a.pw;
    const uint8_t* end = a.rows + a.n * a.pw;
    for (int i = tid; i < tr * wpr; i += kRows) {
      const int r = i / wpr;
      const int k = i - r * wpr;
      s_pk[r * kStageStride + k] = load_word(base + r * a.pw + 4 * k, end);
    }
  }
  __syncthreads();
  if (!live) return;

  float acc[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) acc[i] = 0.f;
  if constexpr (S == Src::kVec16) {
    for (int j0 = 0; j0 < a.w; j0 += 16) {
      uint4 nxt = cur;
      if (j0 + 16 < a.w)
        nxt = __ldg(reinterpret_cast<const uint4*>(src + j0 + 16));
      const uint32_t words[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int c = (words[jj >> 2] >> (8 * (jj & 3))) & 0xff;
        add_segment<QT>(acc, s_tab[c], s_q + (j0 + jj) * QT);
      }
      cur = nxt;
    }
  } else if constexpr (S == Src::kBytes) {
    for (int j = 0; j < a.w; ++j)
      add_segment<QT>(acc, s_tab[__ldg(src + j)], s_q + j * QT);
  } else {
    const uint32_t* pk = s_pk + tid * kStageStride;
    const auto byte = [pk](int m) {
      return static_cast<int>((pk[m >> 2] >> (8 * (m & 3))) & 0xff);
    };
    for (int j = 0; j < a.w; ++j)
      add_segment<QT>(acc, s_tab[unpack_symbol(byte, j, a.b, a.pw)],
                      s_q + j * QT);
  }
#pragma unroll
  for (int i = 0; i < QT; ++i)
    if (q0 + i < a.nq)
      a.out[static_cast<long long>(q0 + i) * a.n + row] =
          __fmul_rn(a.scale, acc[i]);
}

template <typename Tag, Src S>
cudaError_t launch_src(const BoundArgs& a, int qt, dim3 grid,
                       cudaStream_t stream) {
  switch (qt) {
    case 1: bound_kernel<Tag, 1, S><<<grid, kRows, 0, stream>>>(a); break;
    case 2: bound_kernel<Tag, 2, S><<<grid, kRows, 0, stream>>>(a); break;
    default: bound_kernel<Tag, 4, S><<<grid, kRows, 0, stream>>>(a); break;
  }
  return cudaGetLastError();
}

// One launch of the plan (qt, grid) over a with symbols from src.  What
// guards memory is checked here: a grid that covers every pair and, for
// staged rows, a packed width that fits the stride.  Returns
// cudaErrorInvalidValue (and touches no runtime state) on a plan that
// breaks one.
template <typename Tag>
cudaError_t launch_bound(const BoundArgs& a, Src src, int qt, int grid_x,
                         int grid_y, cudaStream_t stream) {
  const bool staged = src == Src::kStaged;
  const bool ok =
      a.nq >= 1 && a.n >= 1 && a.w >= 1 && a.w <= kMaxW && a.card >= 1 &&
      a.card <= kTabEntries && (qt == 1 || qt == 2 || qt == 4) &&
      grid_x >= 1 && static_cast<long long>(grid_x) * kRows >= a.n &&
      grid_y >= 1 && grid_y <= 65535 &&
      static_cast<long long>(grid_y) * qt >= a.nq &&
      (!staged || (a.b >= 1 && a.b < 8 && a.pw == (a.w * a.b + 7) / 8));
  if (!ok) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  switch (src) {
    case Src::kVec16:
      return launch_src<Tag, Src::kVec16>(a, qt, grid, stream);
    case Src::kStaged:
      return launch_src<Tag, Src::kStaged>(a, qt, grid, stream);
    default:
      return launch_src<Tag, Src::kBytes>(a, qt, grid, stream);
  }
}

// The in-place source for rows of w one-byte symbols at p: 16 bytes at a
// time where w and the address allow it.
inline Src in_place_src(const uint8_t* p, int w) {
  return w % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0
             ? Src::kVec16 : Src::kBytes;
}

}  // namespace coconut
