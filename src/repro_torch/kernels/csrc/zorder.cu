// zorder: SAX codes [N, w] u8 -> z-order (invSAX) keys [N, n_words], each
// 32-bit word held zero-extended in an int64 (the port's key layout,
// core/keys.py).
//
// Replaces the TPU kernel src/repro/kernels/zorder.py (zorder_pallas,
// pl.pallas_call at line 45): the paper's Algorithm 1, the second of the two
// construction stages, run by the external-sort bulk load (one launch per
// 65,536-row chunk), by tree.build given precomputed codes and by the seed
// probe's query keys.
//
// What bounds it on an H100: bytes in principle, instructions in practice.
// Per row it reads w bytes of codes (16 B at w = 16) and writes 8 n_words
// bytes (32 B at 128 key bits), 3 bytes a (row, segment) pair; the bit
// permutation costs about 38 instructions a pair (SASS, w = 16), so the
// issue rate, not HBM, holds it (PERF.md): the design spends as few
// instructions a pair as it can.
//
// Design: the summarize tile's layout without the summing
// (summarize_tile.cuh), and its key stage (key_stage.cuh), so sax_summarize
// + zorder == fused_build by construction.  A block of 256 threads walks
// tiles of up to 16 * 256 codes (whole rows) on a persistent grid, as the
// summarize tile does.  A thread loads 16 codes of its tile (one 16-byte
// load, a warp's loads 512 contiguous bytes), stores them to shared memory
// (two buffers, one barrier a tile), and issues its next tile's load before
// the block keys the current one, so 16 bytes a thread are in flight (one
// code a thread, one byte in flight, was 1.2–1.9x slower: PERF.md).  Where
// w is a power of two the tile is 16 rounds of the summarize tile's layout:
// in round k thread t holds pair k * 256 + t (row-major) and ballot_word
// builds the key words, one ballot per bit plane, each stored through a
// pointer that moves 256 / w rows a round; w = 8, 16 and 64 are
// compile-time.  At every other width thread t builds the keys of rows t,
// t + 256, ... of the tile with row_key from the codes in shared memory (a
// tile is at most 256 rows there).  A tile past the last row reads zero
// codes and writes no key.  A codes pointer that is not 16-byte aligned (a
// row slice) takes the same tile with byte loads.
#include "key_stage.cuh"

namespace coconut {
namespace {

constexpr int kZThreads = 256;        // threads a block
constexpr int kZVec = 16;             // codes a thread loads a tile
constexpr int kZTile = kZVec * kZThreads;   // code bytes a tile, at most
constexpr int kZBlocksPerSm = 4;      // resident blocks an SM (the plan's grid)
constexpr int kZRows = -1;            // W of the row_key tile

struct ZArgs {
  const uint8_t* codes;   // [n, w]
  long long* keys;        // [n, nw]
  long long n;
  int w, bits, nw;
  int rows;               // rows a tile: rows * w <= kZTile
};

// The thread's 16 codes of tile t (bytes 16 tid ..), little-endian in a
// uint4; codes past the last row read as 0.
template <bool kVec>
__device__ __forceinline__ uint4 load_codes(const ZArgs& a, long long t) {
  const long long tb = t * a.rows * a.w;   // the tile's first byte
  const int o = kZVec * threadIdx.x;
  const long long left =
      min(static_cast<long long>(a.rows * a.w), a.n * a.w - tb) - o;
  if (kVec && left >= kZVec)
    return __ldg(reinterpret_cast<const uint4*>(a.codes + tb + o));
  unsigned u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kZVec; ++e)
    if (e < left) u[e >> 2] |= static_cast<unsigned>(a.codes[tb + o + e])
                               << (8 * (e & 3));
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// W > 0: ballot_keys at that width; 0: ballot_keys at a runtime power of
// two; kZRows: row_key.  kVec: the codes pointer is 16-byte aligned
// (16-byte loads).
template <int W, bool kVec>
__global__ void __launch_bounds__(kZThreads, kZBlocksPerSm)
zorder_kernel(ZArgs a) {
  __shared__ __align__(16) uint8_t s_codes[2][kZTile + 16];
  const int tid = threadIdx.x;
  const long long tiles = (a.n + a.rows - 1) / a.rows;
  KeyLane kl{};
  // ballot_keys' store in round 0 of a tile: the lane's row and key word
  // (it moves by kZThreads / w rows a round), and whether it stores at all
  int lane_row = 0, lane_word = 0;
  bool stores = false;
  if constexpr (W >= 0) {
    kl = key_lane(W > 0 ? W : a.w, a.nw);
    const int lane = tid & (kWarp - 1);
    if (a.w <= kWarp) {
      lane_row = ((tid - lane) >> kl.lw) + kl.g;
      lane_word = kl.kw;
      stores = kl.mine;
    } else {
      lane_row = tid >> kl.lw;
      lane_word = lane * (a.w >> 5) + ((tid & (a.w - 1)) >> 5);
      stores = lane < a.bits;
    }
  }
  if (tid < 4) {   // the pad past a full tile that row_key's last reads touch
    reinterpret_cast<unsigned*>(s_codes[0] + kZTile)[tid] = 0u;
    reinterpret_cast<unsigned*>(s_codes[1] + kZTile)[tid] = 0u;
  }
  long long t = blockIdx.x;
  uint4 next = make_uint4(0u, 0u, 0u, 0u);
  if (t < tiles) next = load_codes<kVec>(a, t);
  for (int it = 0; t < tiles; t += gridDim.x, ++it) {
    uint8_t* buf = s_codes[it & 1];
    *reinterpret_cast<uint4*>(buf + kZVec * tid) = next;
    if (t + gridDim.x < tiles) next = load_codes<kVec>(a, t + gridDim.x);
    __syncthreads();   // the tile's codes are visible
    const long long row0 = t * a.rows;
    const int live_rows =
        static_cast<int>(min(static_cast<long long>(a.rows), a.n - row0));
    long long* keys = a.keys + row0 * a.nw;
    if constexpr (W >= 0) {
      // round k: pairs k * kZThreads + tid, ballot_keys' layout; the rounds
      // unrolled where w is compile-time (at run time they would not fit
      // the registers)
      const int rows_round = kZThreads >> kl.lw;
      const int step = rows_round * a.nw;
      int row = lane_row;
      long long* key = keys + lane_row * a.nw + lane_word;
#pragma unroll (W > 0 ? kZVec : 1)
      for (int k = 0; k < kZVec; ++k) {
        store_key(key, ballot_word<W>(kl, buf[k * kZThreads + tid], a.bits),
                  stores && row < live_rows);
        row += rows_round;
        key += step;
      }
    } else {
      const unsigned* b32 = reinterpret_cast<const unsigned*>(buf);
      for (int r = tid; r < live_rows; r += kZThreads) {
        const int base = r * a.w;
        const auto code4 = [&](int j) {
          const int o = base + j;
          return __byte_perm(b32[o >> 2], b32[(o >> 2) + 1],
                             0x3210 + 0x1111 * (o & 3));
        };
        long long* key = keys + r * a.nw;
        row_key<false>(code4, a.w, a.bits,
                       [&](int kw, unsigned word) { key[kw] = word; });
      }
    }
  }
}

template <int W>
cudaError_t launch(const ZArgs& a, int grid, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(a.codes) % 16 == 0)
    zorder_kernel<W, true><<<grid, kZThreads, 0, s>>>(a);
  else
    zorder_kernel<W, false><<<grid, kZThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace coconut

// C entry point.  Returns a cudaError_t (0 on success).  Requires n >= 1,
// 1 <= w <= 64, 1 <= bits <= 8, nw = ceil(w * bits / 32), rows a tile with
// rows * w <= 4096 (== where w is a power of two; rows <= 256 elsewhere), a
// multiple of 16 bytes, and grid >= 1 (the wrapper's launch plan, kernels/zorder.py).  Code
// values < 2^bits.
extern "C" int coconut_zorder(const uint8_t* codes, long long* keys, long long n,
                              int w, int bits, int nw, int rows, int grid,
                              void* stream) {
  using namespace coconut;
  if (n < 1 || w < 1 || w > kMaxW || bits < 1 || bits > kMaxBits ||
      nw != (w * bits + 31) / 32 || rows < 1 || rows * w > kZTile ||
      (ballot_width(w) ? rows * w != kZTile : rows > kZThreads) ||
      rows * w % 16 != 0 ||
      grid < 1)
    return cudaErrorInvalidValue;
  const ZArgs a{codes, keys, n, w, bits, nw, rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!ballot_width(w)) return launch<kZRows>(a, grid, s);
  switch (w) {
    case 16: return launch<16>(a, grid, s);
    case 8: return launch<8>(a, grid, s);
    case 64: return launch<64>(a, grid, s);
    default: return launch<0>(a, grid, s);
  }
}
