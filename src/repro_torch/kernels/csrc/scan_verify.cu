// scan_verify: the fused SIMS scan.  For queries [Q, L] (PAAs [Q, w]) against
// rows with codes [N, w] u8 and raw series [N, L] f32: the iSAX lower bound,
// the live mask md < bound[q] on rows not dead, the squared ED of live pairs
// only, each query's top-k, per-query live counts and the union count (rows
// live for any query).  Outputs: dists [Q, k] f32 (inf-padded), rows [Q, k]
// i32 (-1 where the dist is inf), counts [Q] i32, union [1] i32.
//
// Replaces the TPU kernel src/repro/kernels/scan_verify.py
// (scan_verify_pallas, pl.pallas_call at line 130).
//
// What bounds it on an H100: bytes in the common case.  Every row's codes are
// read (w bytes); raw rows are read only for live pairs (the early abandon),
// so a well-pruned group moves little more than its codes, and the live
// pairs' ED (3 flops per element) takes over only when most rows survive.
//
// Design.  The TPU kernel carries its running top-k across grid steps, which
// run in order there; Hopper runs blocks in no fixed order, so the work is
// split into two launches:
//   1. scan_verify_tiles: grid (row tiles of 256, query tiles of 8).  Each
//      thread bounds one row against the block's 8 queries and keeps the live
//      bits in shared memory; counts come from warp ballots plus integer
//      atomics, and the union from a per-row flag set with atomicOr (a row
//      counts once, whichever block sees it live first), so both are exact and
//      deterministic.  Then each warp owns one query: it walks the tile's live
//      rows in row order, computes ED with ed_warp (the routine batch_euclid
//      uses, so fused and eager distances are bit-identical) and keeps a
//      sorted top-k in registers (slots lane and lane + 32, k <= 64), written
//      out as the tile's partial list [tiles, Q, k].
//   2. scan_verify_merge: one warp per query folds the tiles' lists in tile
//      order.
// Ties go to the lowest row: rows reach each list in increasing order and an
// entry is inserted after every entry with an equal or smaller distance, which
// is the (dist, row) order of the reference's k rounds of first-argmin.
// FMA contraction: none (see common.cuh).
#include <math.h>

#include "common.cuh"

namespace coconut {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kTile = kThreads;   // rows per block
constexpr int kQTile = kWarps;    // queries per block: one per warp

// Sorted (dist, row) list of up to 64 entries held by a warp: lane l holds
// slots l (d0, i0) and l + 32 (d1, i1).  Inserts (d, row) when d beats slot
// k - 1, after every entry <= d.  d, row and k are the same on every lane.
struct TopK {
  float d0 = INFINITY, d1 = INFINITY;
  int i0 = -1, i1 = -1;

  __device__ __forceinline__ float kth(int k) const {
    return k <= kWarp ? __shfl_sync(kFull, d0, k - 1)
                      : __shfl_sync(kFull, d1, k - 1 - kWarp);
  }

  __device__ __forceinline__ void insert(float d, int row, int k, int lane) {
    const unsigned b0 = __ballot_sync(kFull, lane < k && d0 <= d);
    const unsigned b1 = __ballot_sync(kFull, lane + kWarp < k && d1 <= d);
    const int p = __popc(b0) + __popc(b1);
    const float up_d0 = __shfl_up_sync(kFull, d0, 1);
    const int up_i0 = __shfl_up_sync(kFull, i0, 1);
    const float up_d1 = __shfl_up_sync(kFull, d1, 1);
    const int up_i1 = __shfl_up_sync(kFull, i1, 1);
    const float last_d0 = __shfl_sync(kFull, d0, kWarp - 1);
    const int last_i0 = __shfl_sync(kFull, i0, kWarp - 1);
    const float prev_d1 = lane == 0 ? last_d0 : up_d1;
    const int prev_i1 = lane == 0 ? last_i0 : up_i1;
    if (lane == p) {
      d0 = d; i0 = row;
    } else if (lane > p) {
      d0 = up_d0; i0 = up_i0;
    }
    if (lane + kWarp == p) {
      d1 = d; i1 = row;
    } else if (lane + kWarp > p) {
      d1 = prev_d1; i1 = prev_i1;
    }
  }

  __device__ __forceinline__ void store(float* d, int* idx, int k, int lane) const {
    if (lane < k) { d[lane] = d0; idx[lane] = i0; }
    if (lane + kWarp < k) { d[lane + kWarp] = d1; idx[lane + kWarp] = i1; }
  }
};

template <int W>
__global__ void __launch_bounds__(kThreads)
scan_verify_tiles(const float* __restrict__ queries,
                  const float* __restrict__ q_paas,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ raw,
                  const float* __restrict__ lower,
                  const float* __restrict__ upper,
                  const float* __restrict__ bound,
                  const int* __restrict__ dead, int* __restrict__ flags,
                  float* __restrict__ part_d, int* __restrict__ part_i,
                  int* __restrict__ counts, int* __restrict__ union_count,
                  int nq, int n, int w, int L, int card, int k, float scale) {
  extern __shared__ float smem[];
  float* s_lo = smem;
  float* s_hi = s_lo + card;
  float* s_qp = s_hi + card;                 // [kQTile, w]
  float* s_q = s_qp + kQTile * w;            // [kQTile, L]
  float* s_bound = s_q + kQTile * L;         // [kQTile]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_bound + kQTile);  // [kTile]
  int* s_cnt = reinterpret_cast<int*>(s_mask + kTile);               // [kQTile]
  int* s_union = s_cnt + kQTile;

  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int q0 = blockIdx.y * kQTile;
  const int tq = min(kQTile, nq - q0);
  const int tile0 = blockIdx.x * kTile;

  for (int i = tid; i < card; i += kThreads) {
    s_lo[i] = lower[i];
    s_hi[i] = upper[i];
  }
  for (int i = tid; i < tq * w; i += kThreads) s_qp[i] = q_paas[q0 * w + i];
  for (int i = tid; i < tq * L; i += kThreads)
    s_q[i] = queries[static_cast<long long>(q0) * L + i];
  if (tid < kQTile) {
    s_bound[tid] = tid < tq ? bound[q0 + tid] : 0.f;
    s_cnt[tid] = 0;
  }
  if (tid == 0) *s_union = 0;
  __syncthreads();

  // -- phase 1: bound every row of the tile against the block's queries ------
  const int row = tile0 + tid;
  unsigned bits = 0;
  if (row < n && (dead == nullptr || dead[row] == 0)) {
    int c[W > 0 ? W : kMaxW];
    load_codes<W>(codes, row, w, c);
    for (int qi = 0; qi < tq; ++qi) {
      const float md = mindist_row<W>(c, s_qp + qi * w, s_lo, s_hi, w, scale);
      if (md < s_bound[qi]) bits |= 1u << qi;
    }
  }
  s_mask[tid] = bits;
  for (int qi = 0; qi < tq; ++qi) {
    const int cnt = __popc(__ballot_sync(kFull, (bits >> qi) & 1u));
    if (lane == 0 && cnt) atomicAdd(&s_cnt[qi], cnt);
  }
  if (bits != 0 && atomicOr(&flags[row], 1) == 0) atomicAdd(s_union, 1);
  __syncthreads();
  if (tid < tq && s_cnt[tid]) atomicAdd(&counts[q0 + tid], s_cnt[tid]);
  if (tid == 0 && *s_union) atomicAdd(union_count, *s_union);

  // -- phase 2: one warp per query verifies its live rows in row order ------
  if (warp >= tq) return;
  TopK top;
  const float* q = s_q + warp * L;
  for (int base = 0; base < kTile; base += kWarp) {
    unsigned live = __ballot_sync(kFull, (s_mask[base + lane] >> warp) & 1u);
    while (live) {
      const int r = __ffs(live) - 1;
      live &= live - 1;
      const int hit = tile0 + base + r;
      const float d = ed_warp(raw + static_cast<long long>(hit) * L, q, L, lane);
      if (d < top.kth(k)) top.insert(d, hit, k, lane);
    }
  }
  const long long off =
      (static_cast<long long>(blockIdx.x) * nq + q0 + warp) * k;
  top.store(part_d + off, part_i + off, k, lane);
}

// One warp per query: fold the tiles' sorted lists in tile order.
__global__ void __launch_bounds__(kWarp)
scan_verify_merge(const float* __restrict__ part_d,
                  const int* __restrict__ part_i, float* __restrict__ out_d,
                  int* __restrict__ out_i, int nq, int tiles, int k) {
  const int q = blockIdx.x;
  const int lane = threadIdx.x;
  TopK top;
  for (int t = 0; t < tiles; ++t) {
    const long long off = (static_cast<long long>(t) * nq + q) * k;
    const float ld0 = lane < k ? part_d[off + lane] : 0.f;
    const int li0 = lane < k ? part_i[off + lane] : -1;
    const float ld1 = lane + kWarp < k ? part_d[off + lane + kWarp] : 0.f;
    const int li1 = lane + kWarp < k ? part_i[off + lane + kWarp] : -1;
    for (int s = 0; s < k; ++s) {
      const float cd = s < kWarp ? __shfl_sync(kFull, ld0, s)
                                 : __shfl_sync(kFull, ld1, s - kWarp);
      const int ci = s < kWarp ? __shfl_sync(kFull, li0, s)
                               : __shfl_sync(kFull, li1, s - kWarp);
      if (!(cd < top.kth(k))) break;   // each list is sorted: the rest lose too
      top.insert(cd, ci, k, lane);
    }
  }
  top.store(out_d + static_cast<long long>(q) * k,
            out_i + static_cast<long long>(q) * k, k, lane);
}

template <int W>
cudaError_t launch_tiles(const float* queries, const float* q_paas,
                         const uint8_t* codes, const float* raw,
                         const float* lower, const float* upper,
                         const float* bound, const int* dead, int* flags,
                         float* part_d, int* part_i, int* counts, int* union_count,
                         int nq, int n, int w, int L, int card, int k, float scale,
                         cudaStream_t stream) {
  const size_t smem = (2 * card + kQTile * w + kQTile * L + kQTile) * sizeof(float) +
                      kTile * sizeof(unsigned) + (kQTile + 1) * sizeof(int);
  cudaError_t err = allow_smem(scan_verify_tiles<W>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, (nq + kQTile - 1) / kQTile);
  scan_verify_tiles<W><<<grid, kThreads, smem, stream>>>(
      queries, q_paas, codes, raw, lower, upper, bound, dead, flags, part_d,
      part_i, counts, union_count, nq, n, w, L, card, k, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace coconut

// Row tiles of the first launch: the caller sizes part_d/part_i as
// [tiles, nq, k].
extern "C" int coconut_scan_verify_tiles_for(int n) {
  return (n + coconut::kTile - 1) / coconut::kTile;
}

// C entry point: both launches.  Returns a cudaError_t (0 on success).
// Requires nq >= 1, 1 <= n < 2^31, 1 <= w <= 64, 1 <= k <= 64; flags [n] and
// counts [nq], union_count [1] zeroed by the caller; dead may be null.
extern "C" int coconut_scan_verify(const float* queries, const float* q_paas,
                                   const uint8_t* codes, const float* raw,
                                   const float* lower, const float* upper,
                                   const float* bound, const int* dead,
                                   int* flags, float* part_d, int* part_i,
                                   float* out_d, int* out_i, int* counts,
                                   int* union_count, int nq, int n, int w, int L,
                                   int card, int k, float scale, void* stream) {
  using namespace coconut;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t p = reinterpret_cast<uintptr_t>(codes);
  cudaError_t err;
  if (w == 16 && p % 16 == 0)
    err = launch_tiles<16>(queries, q_paas, codes, raw, lower, upper, bound, dead,
                           flags, part_d, part_i, counts, union_count, nq, n, w,
                           L, card, k, scale, s);
  else if (w == 8 && p % 8 == 0)
    err = launch_tiles<8>(queries, q_paas, codes, raw, lower, upper, bound, dead,
                          flags, part_d, part_i, counts, union_count, nq, n, w,
                          L, card, k, scale, s);
  else
    err = launch_tiles<0>(queries, q_paas, codes, raw, lower, upper, bound, dead,
                          flags, part_d, part_i, counts, union_count, nq, n, w,
                          L, card, k, scale, s);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kTile - 1) / kTile;
  scan_verify_merge<<<nq, kWarp, 0, s>>>(part_d, part_i, out_d, out_i, nq, tiles, k);
  return cudaGetLastError();
}
