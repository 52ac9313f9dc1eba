// scan_verify: the fused SIMS scan.  For queries [Q, L] (PAAs [Q, w]) against
// rows with codes [N, w] u8 and raw series [N, L] f32: the iSAX lower bound,
// the live mask md < bound[q] on rows not dead, the squared ED of live pairs
// only, each query's top-k, per-query live counts and the union count (rows
// live for any query).  Outputs: dists [Q, k] f32 (inf-padded), rows [Q, k]
// i32 (-1 where the dist is not finite), counts [Q] i32, union [1] i32.
//
// Replaces the TPU kernel src/repro/kernels/scan_verify.py
// (scan_verify_pallas, pl.pallas_call at line 130).
//
// What bounds it on an H100.  At the main path's shape (Q=64, one 2000-row
// leaf, L=256, k=10) the bytes it must move (codes, the live rows once, the
// queries, the outputs) take under a microsecond at 3.35 TB/s and the live
// pairs' ED (3 flops per element) less, so the bound is latency: one launch,
// then dependent trips to memory (codes, live raw rows and queries, the
// other blocks' lists) and the block barriers between the stages.
//
// Design: one launch per call, no fill kernel, every output written here.
//   * Grid over row tiles of `tile` rows (chosen by the wrapper so that the
//     grid fills the card); a block strides over tiles t = blockIdx.x,
//     + gridDim.x, ... and holds every query, in chunks of qc queries when
//     Q * L floats do not fit shared memory (a loop inside the block).
//     Copies into shared memory are cp.async, issued by every thread and in
//     flight together.
//   * Bound: one warp per (row, 32 queries) computes mindist_row (the
//     terms of mindist_batch) lane by lane from the tile's staged codes and
//     the PAAs staged query-minor (adjacent lanes read adjacent words), and
//     ballots the live bits into a per-row query mask.  Per-query counts are
//     popcounts of the masks (integer sums, exact in any order); a row is in
//     the union when its mask is nonzero, counted by the one block that holds
//     all of its bits, so no per-row flag array is needed.  With several
//     query chunks, a row not live for the first chunk is tested against the
//     other queries' bounds during the first chunk's pass.
//   * Verify: the tile's live raw rows (nonzero masks) and the queries with
//     a live pair not yet staged are copied in together, each row read from
//     device memory once per launch and query chunk.  The live (row, query)
//     pairs are compacted query-major by a prefix sum over the per-query
//     counts and spread round-robin over all warps of the block, so no warp
//     walks one dense query alone.  Each pair's distance is ed_warp
//     (common.cuh) on shared-memory pointers: the lane order and butterfly of
//     batch_euclid, so fused and eager distances are bit-identical.
//   * Order-free top-k: a pair's key is (float bits of d) << 32 | row, which
//     for d >= 0 orders by (dist, lowest row), the twin's stable-sort order.
//     The k smallest keys of a set do not depend on the order they arrive
//     in, so block scheduling cannot change a bit.  Each query's list in a
//     block is sorted in a warp's registers (TopK) as the tile's keys are
//     offered to it, then written to the lists buffer with its length.  The
//     last block to finish (__threadfence, then an atomic ticket) folds them:
//     it stages every list's length and first key, sorts a query's keys with
//     a warp bitonic network when they number at most 32, else walks the
//     sorted lists through TopK; it writes the outputs and sets the counters
//     (ticket, union, per-query sums) back to zero for the next call.
// What this does about the earlier two-launch design: (1) the dependent chain
// of one warp per (row tile, query), a device-memory round trip per live row,
// becomes balanced work on staged rows; (2) a live row is read once per
// launch, not once per query tile; (3) five fills and a merge launch become
// one launch.  The fold stays inside that launch (the last block does it)
// rather than in a second one, which would add a launch's latency to every
// call.  What would move it further is more rows per launch, that is
// several leaf groups per call: that changes which rows the executor's
// per-group bound prunes, and belongs to the executor-loop work.
// FMA contraction: none (see common.cuh).
#include <math.h>

#include <atomic>

#include "common.cuh"

namespace coconut {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxTile = 64;     // rows per tile; pairs are coded q << 8 | r
constexpr int kMaxGrid = 128;    // blocks: a fold lane walks 4 lists
constexpr int kFoldGroups = kMaxGrid / kWarp;
constexpr int kFoldQueries = kWarps * kWarp;   // per fold pass
constexpr int kFoldScratch = kWarps * kWarp * 8;   // a key per lane
constexpr unsigned long long kNoKey = ~0ull;
constexpr int kBlockSmem = 232448;   // shared memory an H100 block can use

// The block's shared-memory regions, in the order of the wrapper's plan
// (kernels/scan_verify.py: smem_layout), which gives each one's offset.
enum Region {
  kList,      // the block's lists [qc, k] u64
  kPkey,      // keys of the tile's pairs [tile * qc] u64
  kQ,         // queries [qc, L]
  kRows,      // live rows [<= tile, L]
  kPaa,       // PAAs [w, qc]
  kLo,        // breakpoint tables [card] each
  kHi,
  kBound,     // [qc]
  kMask,      // [tile, nw] query bits
  kPair,      // q << 8 | r, query-major [tile * qc]
  kCnt,       // live rows per query in the tile [qc]
  kOff,       // exclusive prefix of cnt [qc + 1]
  kTcnt,      // live rows per query in the block [qc]
  kQstate,    // query staged / wanted [qc]
  kSlot,      // row -> staged slot or -1 [tile]
  kSlotrow,   // staged slot -> row [tile]
  kDead,      // the tile's dead flags [tile]
  kCodes,     // the tile's codes [tile, w] u8
  kMisc,      // union, live rows, last
  kRegions
};

// One call's inputs, outputs, shapes and launch plan.
struct Args {
  const float* queries;    // [nq, L]
  const float* q_paas;     // [nq, w]
  const uint8_t* codes;    // [n, w]
  const float* raw;        // [n, L]
  const float* lower;      // [card]
  const float* upper;      // [card]
  const float* bound;      // [nq]
  const uint8_t* dead;     // [n] or null
  // counters: ticket, union, pad, pad, then live rows per query [nq]; zero
  // before every call and left zero by it
  int* ctr;
  // lists: per (query, block) list lengths u8 [nq, grid], then (16-byte
  // aligned) list entries u64 [k, nq, grid]: entry j of block b's list for
  // query q at (j * nq + q) * grid + b, so the lengths and first entries of
  // all lists are contiguous
  unsigned char* lists;
  float* out_d;            // [nq, k]
  int* out_i;              // [nq, k]
  int* counts;             // [nq]
  int* union_count;        // [1]
  int nq, n, w, L, card, k;
  float scale;
  int tile, qc;            // rows per tile, queries per chunk
  int smem;                // shared-memory bytes of the block
  int off[kRegions];       // byte offset of each region
  bool vec_q, vec_raw;     // rows of queries / raw may be copied 16 B at once
};

__device__ __forceinline__ unsigned long long pair_key(float d, int row) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned>(row);
}

// Insert key (the same on every lane, not in the list) at its rank in the
// warp's sorted list s (lane l holds slots l in .x and l + 32 in .y).
__device__ __forceinline__ ulonglong2 insert_key(ulonglong2 s,
                                              unsigned long long key, int k) {
  const int lane = threadIdx.x % kWarp;
  const unsigned b0 = __ballot_sync(kFull, lane < k && s.x < key);
  const unsigned b1 = __ballot_sync(kFull, lane + kWarp < k && s.y < key);
  const int p = __popc(b0) + __popc(b1);
  const unsigned long long up0 = __shfl_up_sync(kFull, s.x, 1);
  const unsigned long long up1 = __shfl_up_sync(kFull, s.y, 1);
  const unsigned long long last0 = __shfl_sync(kFull, s.x, kWarp - 1);
  const unsigned long long prev1 = lane == 0 ? last0 : up1;
  ulonglong2 r = s;
  if (lane == p) {
    r.x = key;
  } else if (lane > p) {
    r.x = up0;
  }
  if (lane + kWarp == p) {
    r.y = key;
  } else if (lane + kWarp > p) {
    r.y = prev1;
  }
  return r;
}

// Sorted list of the up to 64 smallest keys offered to a warp: lane l holds
// slots l (s.x) and l + 32 (s.y); empty slots hold kNoKey.  k is the same on
// every lane.
struct TopK {
  ulonglong2 s = make_ulonglong2(kNoKey, kNoKey);

  __device__ __forceinline__ void load(const unsigned long long* src, int k,
                                       int lane) {
    s.x = lane < k ? src[lane] : kNoKey;
    s.y = lane + kWarp < k ? src[lane + kWarp] : kNoKey;
  }

  __device__ __forceinline__ void store(unsigned long long* dst, int k,
                                        int lane) const {
    if (lane < k) dst[lane] = s.x;
    if (lane + kWarp < k) dst[lane + kWarp] = s.y;
  }

  __device__ __forceinline__ unsigned long long kth(int k) const {
    return k <= kWarp ? __shfl_sync(kFull, s.x, k - 1)
                      : __shfl_sync(kFull, s.y, k - 1 - kWarp);
  }

  // Offer one key per lane (kNoKey for none).  Returns the ballot of the
  // lanes whose key was below the k-th key when offered.
  __device__ __forceinline__ unsigned offer(unsigned long long key, int k) {
    const unsigned want = __ballot_sync(kFull, key < kth(k));
    unsigned left = want;
    while (left) {
      const int src = __ffs(left) - 1;
      left &= left - 1;
      const unsigned long long c = __shfl_sync(kFull, key, src);
      if (c < kth(k)) s = insert_key(s, c, k);
    }
    return want;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copies into shared memory (cp.async): issued by every thread,
// in flight together, completed by wait_all() and a barrier.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void copy8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy nrows rows of L floats into dst: row r comes from src row
// row0 + (map ? map[r] : r).  vec: L % 4 == 0 and src 16-byte aligned.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           const int* map, long long row0,
                                           int nrows, int L, bool vec) {
  const int per = vec ? L / 4 : L;
  for (int i = threadIdx.x; i < nrows * per; i += kThreads) {
    const int r = i / per;
    const int e = i - r * per;
    const long long sr = row0 + (map ? map[r] : r);
    if (vec)
      copy16(dst + 4 * i, src + sr * L + 4 * e);
    else
      copy4(dst + i, src + sr * L + e);
  }
}

// Copy the query rows qi < nq whose state is 2 (wanted) from src row
// q0 + qi into dst row qi.  The caller marks them 1 (staged) after its next
// barrier, once every thread has read the states.
__device__ __forceinline__ void stage_wanted(float* dst, const float* src,
                                             const int* state, long long q0,
                                             int nq, int L, bool vec) {
  const int per = vec ? L / 4 : L;
  for (int i = threadIdx.x; i < nq * per; i += kThreads) {
    const int qi = i / per;
    if (state[qi] != 2) continue;
    const int e = i - qi * per;
    if (vec)
      copy16(dst + 4 * i, src + (q0 + qi) * L + 4 * e);
    else
      copy4(dst + i, src + (q0 + qi) * L + e);
  }
}

// nbytes from src to dst: 16-byte copies for the bulk when both are 16-byte
// aligned (4-byte ones when both are 4-byte aligned), the rest byte by byte.
__device__ __forceinline__ void stage_bytes(void* dst, const void* src,
                                            size_t nbytes) {
  auto* d = static_cast<unsigned char*>(dst);
  auto* s = static_cast<const unsigned char*>(src);
  const uintptr_t a = reinterpret_cast<uintptr_t>(d) |
                      reinterpret_cast<uintptr_t>(s);
  size_t done = 0;
  if (a % 16 == 0) {
    done = nbytes / 16 * 16;
    for (size_t i = threadIdx.x * 16; i < done; i += kThreads * 16)
      copy16(d + i, s + i);
  } else if (a % 4 == 0) {
    done = nbytes / 4 * 4;
    for (size_t i = threadIdx.x * 4; i < done; i += kThreads * 4)
      copy4(d + i, s + i);
  }
  for (size_t i = done + threadIdx.x; i < nbytes; i += kThreads)
    d[i] = __ldcg(s + i);
}

// The codes of rows [r0, r0 + tr) into dst (tr * w bytes).
template <int W>
__device__ __forceinline__ void stage_codes(uint8_t* dst, const uint8_t* codes,
                                            long long r0, int tr, int w) {
  for (int i = threadIdx.x; i < (W > 0 ? tr : tr * w); i += kThreads) {
    if constexpr (W == 16) {
      copy16(dst + i * 16, codes + (r0 + i) * 16);
    } else if constexpr (W == 8) {
      copy8(dst + i * 8, codes + (r0 + i) * 8);
    } else {
      dst[i] = codes[r0 * w + i];
    }
  }
}

// A row's codes from shared memory (one vector read at w = 16 or 8).
template <int W>
__device__ __forceinline__ void smem_codes(const uint8_t* row, int w, int* c) {
  if constexpr (W == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(row);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) c[j] = (words[j >> 2] >> ((j & 3) * 8)) & 0xff;
  } else if constexpr (W == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(row);
    const uint32_t words[2] = {v.x, v.y};
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = (words[j >> 2] >> ((j & 3) * 8)) & 0xff;
  } else {
    for (int j = 0; j < w; ++j) c[j] = row[j];
  }
}
template <int W>
__global__ void __launch_bounds__(kThreads, 1) scan_verify_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int grid = gridDim.x;
  const int nq = a.nq, n = a.n, w = a.w, L = a.L, k = a.k, qc = a.qc;
  auto* s_list = reinterpret_cast<unsigned long long*>(smem + a.off[kList]);
  auto* s_pkey = reinterpret_cast<unsigned long long*>(smem + a.off[kPkey]);
  auto* s_q = reinterpret_cast<float*>(smem + a.off[kQ]);
  auto* s_rows = reinterpret_cast<float*>(smem + a.off[kRows]);
  auto* s_paa = reinterpret_cast<float*>(smem + a.off[kPaa]);
  auto* s_lo = reinterpret_cast<float*>(smem + a.off[kLo]);
  auto* s_hi = reinterpret_cast<float*>(smem + a.off[kHi]);
  auto* s_bound = reinterpret_cast<float*>(smem + a.off[kBound]);
  auto* s_mask = reinterpret_cast<unsigned*>(smem + a.off[kMask]);
  auto* s_pair = reinterpret_cast<int*>(smem + a.off[kPair]);
  auto* s_cnt = reinterpret_cast<int*>(smem + a.off[kCnt]);
  auto* s_off = reinterpret_cast<int*>(smem + a.off[kOff]);
  auto* s_tcnt = reinterpret_cast<int*>(smem + a.off[kTcnt]);
  auto* s_qstate = reinterpret_cast<int*>(smem + a.off[kQstate]);
  auto* s_slot = reinterpret_cast<int*>(smem + a.off[kSlot]);
  auto* s_slotrow = reinterpret_cast<int*>(smem + a.off[kSlotrow]);
  auto* s_dead = reinterpret_cast<int*>(smem + a.off[kDead]);
  uint8_t* s_codes = smem + a.off[kCodes];
  int* s_misc = reinterpret_cast<int*>(smem + a.off[kMisc]);

  int* ticket = a.ctr;
  int* p_union = a.ctr + 1;
  int* p_tot = a.ctr + 4;
  uint8_t* p_len = a.lists;
  auto* p_keys = reinterpret_cast<unsigned long long*>(
      a.lists + (static_cast<size_t>(nq) * grid + 15) / 16 * 16);

  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int tile = a.tile;
  const int nw = (qc + kWarp - 1) / kWarp;
  const int tiles = (n + tile - 1) / tile;
  const int chunks = (nq + qc - 1) / qc;

  stage_bytes(s_lo, a.lower, a.card * 4);
  stage_bytes(s_hi, a.upper, a.card * 4);
  if (tid == 0) s_misc[0] = 0;

  for (int c = 0; c < chunks; ++c) {
    const int q0 = c * qc;
    const int cq = min(qc, nq - q0);
    __syncthreads();   // the previous chunk is done with shared memory
    for (int i = tid; i < cq * w; i += kThreads) {   // transposed: [w, qc]
      const int qi = i / w;
      copy4(s_paa + (i - qi * w) * qc + qi, a.q_paas + q0 * w + i);
    }
    stage_bytes(s_bound, a.bound + q0, cq * 4);
    for (int i = tid; i < cq; i += kThreads) {
      s_tcnt[i] = 0;
      s_qstate[i] = 0;
    }
    for (int i = tid; i < cq * k; i += kThreads) s_list[i] = kNoKey;

    for (int t = blockIdx.x; t < tiles; t += grid) {
      const int r0 = t * tile;
      const int tr = min(tile, n - r0);
      stage_codes<W>(s_codes, a.codes, r0, tr, w);
      for (int i = tid; i < tr; i += kThreads)
        s_dead[i] = a.dead == nullptr ? 0 : a.dead[r0 + i];
      wait_all();
      __syncthreads();

      // -- bound: one warp per (row, 32 queries) -> query bits, two such
      // tasks at a time so their dependent sums overlap ----------------------
      const auto live_bit = [&](int task) {
        const int r = task / nw;
        const int qi = (task - r * nw) * kWarp + lane;
        if (task >= tr * nw || s_dead[r] != 0 || qi >= cq) return false;
        int cd[W > 0 ? W : kMaxW];
        smem_codes<W>(s_codes + r * w, w, cd);
        return mindist_row<W>(cd, s_paa + qi, s_lo, s_hi, w, a.scale, qc) <
               s_bound[qi];
      };
      for (int task = warp; task < tr * nw; task += 2 * kWarps) {
        const bool x = live_bit(task);
        const bool y = live_bit(task + kWarps);
        const unsigned bits_x = __ballot_sync(kFull, x);
        const unsigned bits_y = __ballot_sync(kFull, y);
        if (lane == 0) {
          s_mask[task] = bits_x;     // task = r * nw + word
          if (task + kWarps < tr * nw) s_mask[task + kWarps] = bits_y;
        }
      }
      __syncthreads();

      // -- counts, staged slots, pair offsets ------------------------------
      for (int qi = tid; qi < cq; qi += kThreads) {
        int cnt = 0;
        for (int r = 0; r < tr; ++r)
          cnt += (s_mask[r * nw + qi / kWarp] >> (qi % kWarp)) & 1u;
        s_cnt[qi] = cnt;
        s_tcnt[qi] += cnt;
        // a query is staged the first time one of its pairs is live
        if (cnt > 0 && s_qstate[qi] == 0) s_qstate[qi] = 2;
      }
      if (warp == 0) {
        int live_rows = 0;
        for (int base = 0; base < tr; base += kWarp) {
          const int r = base + lane;
          bool any = false;
          if (r < tr)
            for (int wd = 0; wd < nw; ++wd) any = any || s_mask[r * nw + wd];
          const unsigned bal = __ballot_sync(kFull, any);
          const int pos = live_rows + __popc(bal & ((1u << lane) - 1u));
          if (any) {
            s_slot[r] = pos;
            s_slotrow[pos] = r;
          } else if (r < tr) {
            s_slot[r] = -1;
          }
          live_rows += __popc(bal);
        }
        if (lane == 0) {
          s_misc[1] = live_rows;
          if (c == 0) atomicAdd(&s_misc[0], live_rows);
        }
      }
      __syncthreads();
      // the live rows and the queries not yet staged with a live pair
      // start on their way while the offsets are summed
      stage_rows(s_rows, a.raw, s_slotrow, r0, s_misc[1], L, a.vec_raw);
      stage_wanted(s_q, a.queries, s_qstate, q0, cq, L, a.vec_q);
      if (warp == 0) {
        int run = 0;
        for (int base = 0; base < cq; base += kWarp) {
          const int qi = base + lane;
          const int v = qi < cq ? s_cnt[qi] : 0;
          int incl = v;
#pragma unroll
          for (int d = 1; d < kWarp; d <<= 1) {
            const int u = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += u;
          }
          if (qi < cq) s_off[qi] = run + incl - v;
          run += __shfl_sync(kFull, incl, kWarp - 1);
        }
        if (lane == 0) s_off[cq] = run;
      } else if (c == 0 && chunks > 1) {
        // union: a row not live for this chunk may be live for another
        for (int r = warp - 1; r < tr; r += kWarps - 1) {
          if (s_slot[r] >= 0 || s_dead[r] != 0) continue;
          int cd[W > 0 ? W : kMaxW];
          smem_codes<W>(s_codes + r * w, w, cd);
          bool hit = false;
          for (int qb = qc; qb < nq && !hit; qb += kWarp) {
            const int qi = qb + lane;
            const bool live =
                qi < nq && mindist_row<W>(cd, a.q_paas + qi * w, s_lo, s_hi,
                                          w, a.scale) < a.bound[qi];
            hit = __any_sync(kFull, live);
          }
          if (hit && lane == 0) atomicAdd(&s_misc[0], 1);
        }
      }
      __syncthreads();

      // -- list the live pairs query-major ---------------------------------
      for (int qi = tid; qi < cq; qi += kThreads) {
        if (s_qstate[qi] == 2) s_qstate[qi] = 1;
        int j = s_off[qi];
        for (int r = 0; r < tr; ++r)
          if ((s_mask[r * nw + qi / kWarp] >> (qi % kWarp)) & 1u)
            s_pair[j++] = (qi << 8) | r;
      }
      wait_all();
      __syncthreads();

      // -- balanced verify: the pairs round-robin over every warp ----------
      const int npairs = s_off[cq];
      for (int p = warp; p < npairs; p += kWarps) {
        const int pr = s_pair[p];
        const int qi = pr >> 8;
        const int r = pr & 0xff;
        const float d = ed_warp(s_rows + s_slot[r] * L, s_q + qi * L, L, lane);
        if (lane == 0) s_pkey[p] = pair_key(d, r0 + r);
      }
      __syncthreads();

      // -- each query's list takes the tile's keys -------------------------
      for (int qi = warp; qi < cq; qi += kWarps) {
        const int cnt = s_cnt[qi];
        if (cnt == 0) continue;
        TopK top;
        top.load(s_list + qi * k, k, lane);
        const unsigned long long* keys = s_pkey + s_off[qi];
        for (int base = 0; base < cnt; base += kWarp)
          top.offer(base + lane < cnt ? keys[base + lane] : kNoKey, k);
        top.store(s_list + qi * k, k, lane);
      }
      __syncthreads();
    }

    // -- this chunk's list lengths, entries and live counts ----------------
    for (int qi = tid; qi < cq; qi += kThreads) {
      p_len[static_cast<size_t>(q0 + qi) * grid + blockIdx.x] =
          static_cast<uint8_t>(min(s_tcnt[qi], k));
      if (s_tcnt[qi] > 0) atomicAdd(p_tot + q0 + qi, s_tcnt[qi]);
    }
    for (int i = tid; i < cq * k; i += kThreads) {
      const int qi = i / k;
      const int j = i - qi * k;
      if (j < s_tcnt[qi])
        p_keys[(static_cast<size_t>(j) * nq + q0 + qi) * grid + blockIdx.x] =
            s_list[i];
    }
  }
  if (tid == 0 && s_misc[0] > 0) atomicAdd(p_union, s_misc[0]);

  // -- the last block to finish folds every block's lists ------------------
  __threadfence();
  __syncthreads();
  if (tid == 0) s_misc[2] = atomicAdd(ticket, 1) == grid - 1;
  __syncthreads();
  const bool last = s_misc[2];
  if (!last) return;
  __threadfence();

  // the length and first entry of every (query, block) list go to shared
  // memory ([fq, grid] each, lanes read adjacent blocks), fq queries a pass
  const int fq = min(min(nq, kFoldQueries),
                     (a.smem - kFoldScratch - 32) / (grid * 9));
  auto* f_buf = reinterpret_cast<unsigned long long*>(smem) + warp * kWarp;
  auto* f_key = reinterpret_cast<unsigned long long*>(smem + kFoldScratch);
  uint8_t* f_len =
      smem + kFoldScratch + (size_t(fq) * grid * 8 + 15) / 16 * 16;
  for (int fq0 = 0; fq0 < nq; fq0 += fq) {
    const int nf = min(fq, nq - fq0);
    __syncthreads();
    const size_t at = static_cast<size_t>(fq0) * grid;
    stage_bytes(f_key, p_keys + at, static_cast<size_t>(nf) * grid * 8);
    stage_bytes(f_len, p_len + at, static_cast<size_t>(nf) * grid);
    // lane i of a warp reads the live count of its query i (in flight
    // with the copies)
    const int mine_q = fq0 + warp + lane * kWarps;
    const int tot = mine_q < fq0 + nf ? __ldcg(p_tot + mine_q) : 0;
    wait_all();
    __syncthreads();

    for (int qq = warp, i = 0; qq < nf; qq += kWarps, ++i) {
      const int qi = fq0 + qq;
      const int cnt = __shfl_sync(kFull, tot, i);
      if (lane == 0) {
        a.counts[qi] = cnt;
        p_tot[qi] = 0;
      }
      // lane l holds the lists of blocks l, l + 32, ...; their first
      // entries come from shared memory, later ones from the workspace
      TopK top;
      if (cnt > 0) {
        int len[kFoldGroups];
        int m = 0;
#pragma unroll
        for (int g = 0; g < kFoldGroups; ++g) {
          const int b = g * kWarp + lane;
          len[g] = b < grid ? f_len[qq * grid + b] : 0;
          m += len[g];
        }
        int before = m;   // exclusive prefix of the lanes' entry counts
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
          const int u = __shfl_up_sync(kFull, before, d);
          if (lane >= d) before += u;
        }
        const int total = __shfl_sync(kFull, before, kWarp - 1);
        before -= m;
        if (total <= kWarp) {
          // few candidates: gather them one per lane and sort the warp's 32
          // keys (a bitonic network), the k smallest first
          int pos = before;
#pragma unroll
          for (int g = 0; g < kFoldGroups; ++g) {
            const size_t b = g * kWarp + lane;
            for (int j = 0; j < len[g]; ++j)
              f_buf[pos++] = j == 0 ? f_key[qq * grid + b]
                                    : __ldcg(p_keys + (j * size_t(nq) + qi) *
                                                          grid + b);
          }
          __syncwarp();
          unsigned long long key = lane < total ? f_buf[lane] : kNoKey;
          __syncwarp();
          for (int size = 2; size <= kWarp; size <<= 1)
            for (int stride = size / 2; stride > 0; stride >>= 1) {
              const unsigned long long other =
                  __shfl_xor_sync(kFull, key, stride);
              const bool up = (lane & size) == 0;   // an ascending run
              key = ((lane & stride) == 0) == up ? min(key, other)
                                                 : max(key, other);
            }
          top.s.x = key;
        } else {
          // many: walk the sorted lists; each round offers every walking
          // list's next key, and a list ends at its length or at its first
          // key not below the k-th key (the keys after it are larger)
          int next[kFoldGroups] = {};
          unsigned long long key[kFoldGroups];
#pragma unroll
          for (int g = 0; g < kFoldGroups; ++g)
            key[g] = len[g] > 0 ? f_key[qq * grid + g * kWarp + lane] : kNoKey;
          while (true) {
            unsigned any = 0;
#pragma unroll
            for (int g = 0; g < kFoldGroups; ++g) {
              if (g * kWarp >= grid) break;
              const unsigned want = top.offer(key[g], k);
              any |= want;
              if ((want >> lane) & 1u) {
                ++next[g];
              } else {
                len[g] = next[g];   // this list is done
              }
            }
            if (!any) break;
#pragma unroll
            for (int g = 0; g < kFoldGroups; ++g) {
              const size_t b = g * kWarp + lane;
              const size_t e = (next[g] * size_t(nq) + qi) * grid + b;
              key[g] = next[g] < len[g] ? __ldcg(p_keys + e) : kNoKey;
            }
          }
        }
      }
      const unsigned long long mine[2] = {top.s.x, top.s.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + h * kWarp;
        if (j >= k) continue;
        const unsigned hi = static_cast<unsigned>(mine[h] >> 32);
        const float d = mine[h] == kNoKey ? INFINITY : __uint_as_float(hi);
        a.out_d[static_cast<size_t>(qi) * k + j] = d;
        a.out_i[static_cast<size_t>(qi) * k + j] =
            isfinite(d) ? static_cast<int>(mine[h] & 0xffffffffu) : -1;
      }
    }
  }
  if (tid == 0) {
    *a.union_count = __ldcg(p_union);
    *p_union = 0;
    *ticket = 0;   // ready for the next call (launches on a stream are ordered)
  }
}

// Lift the kernel's dynamic shared-memory limit to the most a block can use,
// once per device (bit d of `lifted`): a per-call cudaFuncSetAttribute
// costs host time on every launch.
template <int W>
cudaError_t allow_block_smem() {
  static std::atomic<unsigned> lifted{0};
  int dev = 0;
  cudaError_t err = refused(cudaGetDevice(&dev));
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (lifted.load() & bit) return cudaSuccess;
  err = refused(cudaFuncSetAttribute(scan_verify_kernel<W>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     kBlockSmem));
  if (err == cudaSuccess) lifted |= bit;
  return err;
}

template <int W>
cudaError_t launch(const Args& a, int grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_block_smem<W>();
  if (err != cudaSuccess) return err;
  scan_verify_kernel<W><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace coconut

// C entry point: one launch.  Returns a cudaError_t (0 on success).
// Requires nq >= 1, 1 <= n < 2^31, 1 <= w <= 64, 1 <= k <= 64,
// 1 <= tile <= 64, 1 <= qc, 1 <= grid <= min(128, tiles).  smem and
// offsets (kRegions ints, ascending, 16-byte aligned) are the plan's
// shared-memory bytes and region offsets (the wrapper's smem_layout); smem
// must hold the fold's staging.  ctr holds 4 + nq ints, all zero (every
// call leaves them zero); lists holds the per-(query, block) list lengths
// and entries (16-byte aligned nq * grid bytes, then k * nq * grid u64).
// dead (nonzero = excluded) may be null.
extern "C" int coconut_scan_verify(const float* queries, const float* q_paas,
                                   const uint8_t* codes, const float* raw,
                                   const float* lower, const float* upper,
                                   const float* bound, const uint8_t* dead,
                                   int* ctr, void* lists, float* out_d,
                                   int* out_i, int* counts, int* union_count,
                                   int nq, int n, int w, int L, int card, int k,
                                   float scale, int tile, int qc, int grid,
                                   int smem, const int* offsets,
                                   void* stream) {
  using namespace coconut;
  const int tiles = n > 0 && tile > 0 ? (n + tile - 1) / tile : 0;
  bool ok = nq >= 1 && n >= 1 && w >= 1 && w <= kMaxW && k >= 1 &&
            k <= 2 * kWarp && tile >= 1 && tile <= kMaxTile && qc >= 1 &&
            grid >= 1 && grid <= kMaxGrid && grid <= tiles &&
            smem <= kBlockSmem && smem >= grid * 9 + kFoldScratch + 32;
  Args a{queries, q_paas, codes, raw, lower, upper, bound, dead, ctr,
         static_cast<unsigned char*>(lists), out_d, out_i, counts,
         union_count, nq, n, w, L, card, k, scale, tile, qc, smem};
  for (int r = 0; r < kRegions; ++r) {
    a.off[r] = offsets[r];
    ok = ok && offsets[r] % 16 == 0 && offsets[r] < smem &&
         (r == 0 || offsets[r] >= offsets[r - 1]);
  }
  if (!ok) return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.vec_q = L % 4 == 0 && aligned(queries);
  a.vec_raw = L % 4 == 0 && aligned(raw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t p = reinterpret_cast<uintptr_t>(codes);
  if (w == 16 && p % 16 == 0) return launch<16>(a, grid, smem, s);
  if (w == 8 && p % 8 == 0) return launch<8>(a, grid, smem, s);
  return launch<0>(a, grid, smem, s);
}
