// pool_merge: fold one leaf group's candidates into the per-query k-NN pools
// that the exact scan keeps on the card, and count what the group touched.
//
// Replaces no TPU kernel.  The reference merges each leaf group's verified
// rows into its pools on the host (query/merger.py: merge_topk), which on the
// card cost two copies back and up to Q host merges a group.  This kernel
// lets the exact scan issue every group's launches without waiting: the bound
// (mindist_batch), the cross ED (batch_euclid) and this fold run back to back
// on one stream, and the pools come back once a partition.
//
// Per group it takes the bound md [Q, B] and the cross ED dd [Q, B] of the
// group's B rows (leaf `leaves[j / leaf]`, row `j % leaf` of it), the
// partition's dead-row mask (a window cut, or none) and report ids, and the
// pools best_d [Q, k] f32 / best_off [Q, k] i64 with the external bound ext
// [Q].  For query q:
//   * live = md < min(best_d[q, k-1], ext[q]) (strict; NaN-propagating as
//     numpy's minimum), on rows not dead, with the bound read before the
//     fold, as the host loop reads it;
//   * counts[q] += the live rows; row_mark[row] = 1 and leaf_mark[q, leaf] =
//     1 for each live row (the scan's candidates and touched leaves);
//   * when any row is live, the pool becomes merge_topk's: the pool's entries
//     (its first (inf, -1) pad alone) and the live rows whose id is not in the
//     pool, ordered by distance (NaN last), a pool entry before a new one on
//     equal distances and new ones in row order, cut to k, padded with
//     (inf, -1).  A partition's report ids are distinct.
//
// What bounds it on an H100.  At the main path's shape (Q = 64, one 2000-row
// leaf, k = 10) it must read md (512 KB) and, for the live pairs, dd, the ids
// and the dead mask: about 0.3 us at 3.35 TB/s.  The launch (~5 us) and the
// chain of loads a tile (md, the row's leaf and dead flag, then dd and the id)
// bound it instead.  Design: one block a query, 256 threads, the rows in
// tiles of 1024 (four a thread, loads of a tile issued together).  The pool
// sits in shared memory as a list sorted by (distance, order); a live row
// whose distance does not beat a full list's last entry is dropped at once,
// so most tiles end after one barrier.  A tile's other candidates are
// compacted into shared memory and merged by rank: each candidate counts the
// candidates and list entries before it, each list entry the candidates
// before it, and whatever ranks below k lands in the other half of a double
// buffer.  Shared memory: 26 KB static.  FMA: none (no float arithmetic).
#include <math.h>

#include "common.cuh"

namespace coconut {
namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int kMaxK = kThreads;   // a thread per pool entry

struct PoolMergeArgs {
  const float* md;
  const float* dd;
  const long long* leaves;
  const uint8_t* dead;
  const long long* ids;
  float* best_d;
  long long* best_off;
  const float* ext;
  long long* counts;
  uint8_t* row_mark;
  uint8_t* leaf_mark;
  int B, leaf, k, n_leaves;
};

// (distance, order) before (distance, order): NaN after every number, then
// the lower order.  Orders: a pool entry its slot (< kMaxK), a new one
// kMaxK + its row in the group.
__device__ __forceinline__ bool is_nan(float x) { return x != x; }

__device__ __forceinline__ bool before(float da, int oa, float db, int ob) {
  const bool na = is_nan(da), nb = is_nan(db);
  if (na != nb) return nb;
  if (!na && da != db) return da < db;
  return oa < ob;
}

// Exclusive scan of v over the block; *total gets the block's sum.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  int x = v;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == kWarp - 1) s_warp[w] = x;
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < kThreads / kWarp; ++i) {
    const int c = s_warp[i];
    base += i < w ? c : 0;
    tot += c;
  }
  __syncthreads();
  *total = tot;
  return base + x - v;
}

__global__ void __launch_bounds__(kThreads) pool_merge_kernel(PoolMergeArgs a) {
  __shared__ float s_d[2][kMaxK];
  __shared__ int s_ord[2][kMaxK];
  __shared__ long long s_id[2][kMaxK];
  __shared__ long long s_pool[kMaxK];
  __shared__ float t_d[kTile];
  __shared__ int t_ord[kTile];
  __shared__ long long t_id[kTile];
  __shared__ int s_warp[kThreads / kWarp];
  __shared__ int s_first_pad;

  const int q = blockIdx.x, tid = threadIdx.x, k = a.k;
  float* pd = a.best_d + static_cast<long long>(q) * k;
  long long* po = a.best_off + static_cast<long long>(q) * k;
  const float* mdq = a.md + static_cast<long long>(q) * a.B;
  const float* ddq = a.dd + static_cast<long long>(q) * a.B;
  const float kth = pd[k - 1], ex = a.ext[q];
  const float bound = is_nan(kth) || is_nan(ex) ? __int_as_float(0x7fc00000)
                                                : fminf(kth, ex);

  // the pool as a sorted list: every entry but the pads after the first
  if (tid == 0) s_first_pad = k;
  __syncthreads();
  long long pid = 0;
  float pdist = 0.f;
  if (tid < k) {
    pid = po[tid];
    pdist = pd[tid];
    s_pool[tid] = pid;
    if (pid == -1) atomicMin(&s_first_pad, tid);
  }
  __syncthreads();
  const int keep = tid < k && (pid != -1 || tid == s_first_pad);
  int m;
  const int slot = block_scan(keep, s_warp, &m);
  if (keep) {
    s_d[0][slot] = pdist;
    s_ord[0][slot] = tid;
    s_id[0][slot] = pid;
  }
  __syncthreads();

  int cur = 0, n_live = 0;
  for (int base = 0; base < a.B; base += kTile) {
    const bool full = m >= k;
    const float last_d = full ? s_d[cur][m - 1] : 0.f;
    const int last_o = full ? s_ord[cur][m - 1] : 0;
    float d[kRowsPerThread];
    long long id[kRowsPerThread];
    bool on[kRowsPerThread];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int j = base + u * kThreads + tid;
      on[u] = false;
      d[u] = 0.f;
      id[u] = 0;
      if (j >= a.B) continue;
      const int ls = j / a.leaf;
      const long long lf = a.leaves[ls];
      const long long row = lf * a.leaf + (j - ls * a.leaf);
      if (!(mdq[j] < bound) || (a.dead != nullptr && a.dead[row])) continue;
      ++n_live;
      a.row_mark[row] = 1;
      a.leaf_mark[static_cast<long long>(q) * a.n_leaves + lf] = 1;
      d[u] = ddq[j];
      id[u] = a.ids[row];
      bool in = !full || before(d[u], kMaxK + j, last_d, last_o);
      for (int i = 0; in && i < k; ++i) in = s_pool[i] != id[u];
      on[u] = in;
      mine += in;
    }
    int n_on;
    int at = block_scan(mine, s_warp, &n_on);
    if (n_on == 0) continue;
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      if (!on[u]) continue;
      t_d[at] = d[u];
      t_ord[at] = kMaxK + base + u * kThreads + tid;
      t_id[at] = id[u];
      ++at;
    }
    __syncthreads();
    const int nxt = cur ^ 1;
    for (int c = tid; c < n_on; c += kThreads) {
      const float cd = t_d[c];
      const int co = t_ord[c];
      int r = 0;
      for (int u = 0; u < n_on; ++u) r += before(t_d[u], t_ord[u], cd, co);
      int lo = 0, hi = m;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (before(s_d[cur][mid], s_ord[cur][mid], cd, co)) lo = mid + 1;
        else hi = mid;
      }
      r += lo;
      if (r < k) {
        s_d[nxt][r] = cd;
        s_ord[nxt][r] = co;
        s_id[nxt][r] = t_id[c];
      }
    }
    if (tid < m) {
      const float ld = s_d[cur][tid];
      const int lo = s_ord[cur][tid];
      int r = tid;
      for (int u = 0; u < n_on; ++u) r += before(t_d[u], t_ord[u], ld, lo);
      if (r < k) {
        s_d[nxt][r] = ld;
        s_ord[nxt][r] = lo;
        s_id[nxt][r] = s_id[cur][tid];
      }
    }
    m = min(k, m + n_on);
    cur = nxt;
    __syncthreads();
  }

  int live;
  block_scan(n_live, s_warp, &live);
  if (tid == 0) a.counts[q] += live;
  if (live == 0) return;                 // the host loop leaves such a pool
  for (int i = tid; i < k; i += kThreads) {
    pd[i] = i < m ? s_d[cur][i] : INFINITY;
    po[i] = i < m ? s_id[cur][i] : -1;
  }
}

}  // namespace
}  // namespace coconut

// C entry point.  Returns a cudaError_t (0 on success).  Requires nq >= 1,
// 1 <= B < 2^31 - 256, leaf >= 1, 1 <= k <= 256, n_leaves >= 1, every
// array contiguous, `leaves` holding ceil(B / leaf) leaf numbers of a
// partition whose rows the marks cover; `dead` may be null.
extern "C" int coconut_pool_merge(const float* md, const float* dd,
                                  const long long* leaves, const uint8_t* dead,
                                  const long long* ids, float* best_d,
                                  long long* best_off, const float* ext,
                                  long long* counts, uint8_t* row_mark,
                                  uint8_t* leaf_mark, int nq, int B, int leaf,
                                  int k, int n_leaves, void* stream) {
  using namespace coconut;
  if (nq < 1 || B < 1 || B > 0x7fffffff - kMaxK || leaf < 1 || k < 1 ||
      k > kMaxK || n_leaves < 1)
    return cudaErrorInvalidValue;
  const PoolMergeArgs a{md,       dd,        leaves, dead, ids, best_d,
                        best_off, ext,       counts, row_mark, leaf_mark,
                        B,        leaf,      k,      n_leaves};
  pool_merge_kernel<<<nq, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
