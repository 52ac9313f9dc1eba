// The key stage of the three build kernels (zorder.cu, and through the
// summarize tile sax_summarize.cu's twin fused_build.cu): SAX codes -> z-order
// (invSAX) key words.  Global key bit q = i * w + j (MSB first) is bit
// b - 1 - i of segment j; a last word the w * b bits do not fill is
// left-aligned.  Each 32-bit word is stored zero-extended in an int64 (the
// port's key layout, core/keys.py).  Every kernel that writes keys runs one
// of the two routines below, so sax_summarize + zorder == fused_build holds
// by construction.
//
// ballot_keys, where w is a power of two (w divides 32, or is a multiple of
// 32): the codes are held one (row, segment) pair a lane, pairs row-major,
// so a warp holds 32 / w whole rows (w <= 32) or 32 segments of one row
// (w > 32).  Bit plane i of the warp's codes (bit b - 1 - i of each) is one
// __ballot_sync; all kMaxBits planes are taken, the planes past b being
// zero, so the stage has no branch on b.  For w <= 32, lane g * nw + kw
// builds word kw of the warp's row g: it ORs the row's w bits of each plane
// in that word, LSB first at bit (i * w) % 32, and one __brev puts them MSB
// first; at the compile-time widths 8 and 16, whose rows are whole bytes of
// a ballot, byte permutes build each candidate word and a register select
// picks the lane's (no predicate: the ballots' tests fill those).  For w > 32, lane i stores plane i's 32 bits, bit-reversed.
//
// row_key, every other width: one thread builds one row's key, stepping
// (plane i, segment j) along the key's bits in order, four codes at a time
// (plane_nibble: a mask and one multiply gather a plane's bit of four bytes
// into a nibble), and storing each word once it is whole.  Nothing divides
// and no array is indexed at run time.
#pragma once

#include <utility>

#include "common.cuh"

namespace coconut {

constexpr int kPlanes = kMaxBits;   // ballots a warp takes: planes past b are 0

// The warp's ballot of bit 31 - I of each lane's c.  Written in PTX so that
// the test stays one LOP3 into a predicate (the C++ form became a shift, a
// mask and a compare).
template <int I>
__device__ __forceinline__ unsigned plane_ballot(unsigned c) {
  unsigned bal;
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %1, %2;\n\tsetp.ne.b32 p, t, 0;\n\t"
      "vote.sync.ballot.b32 %0, p, 0xffffffff;\n\t}"
      : "=r"(bal) : "r"(c), "n"(0x80000000u >> I));
  return bal;
}

template <int... I>
__device__ __forceinline__ void plane_ballots(unsigned c, unsigned (&bal)[kPlanes],
                                              std::integer_sequence<int, I...>) {
  ((bal[I] = plane_ballot<I>(c)), ...);
}

// (a & ~m) | (b & m): one LOP3, written in PTX so that it stays a register
// select (as C++ it became a compare and a SEL, whose predicates the
// compiler spilled and restored every round around the ballots' R2P).
__device__ __forceinline__ unsigned select_bits(unsigned a, unsigned b,
                                                unsigned m) {
  unsigned d;
  asm("lop3.b32 %0, %1, %2, %3, 0xD8;" : "=r"(d) : "r"(a), "r"(b), "r"(m));
  return d;
}

// *key = word, zero-extended, where ok (as two 32-bit halves, the high one
// zero: the int64 is never sign-extended).
__device__ __forceinline__ void store_key(long long* key, unsigned word,
                                          bool ok) {
  if (ok) *reinterpret_cast<uint2*>(key) = make_uint2(word, 0u);
}

// Is the key stage ballot_keys (else row_key) at width w?
__host__ __device__ constexpr bool ballot_width(int w) {
  return w > 0 && (w & (w - 1)) == 0;
}

__host__ __device__ constexpr int log2_width(int w) {
  return w > 1 ? 1 + log2_width(w >> 1) : 0;
}

// A lane's part in ballot_keys, fixed for a launch, so that the tile loop
// divides by nothing.
struct KeyLane {
  int lw;      // log2 w
  int kw;      // w <= 32: the word this lane builds (lane = g * nw + kw)
  int g;       //          of the warp's row g
  int gw;      //          g * w, the row's first bit in a ballot
  bool mine;   //          g < 32 / w: the lane builds a word
  unsigned perm;      // w = 8, 16: __byte_perm selector of row g's bytes
  unsigned pick[4];   // w = 8, 16: pick[c] all ones where kw == c
};

__device__ __forceinline__ KeyLane key_lane(int w, int nw) {
  const int lane = threadIdx.x & (kWarp - 1);
  KeyLane k;
  k.lw = 31 - __clz(w);
  k.g = lane / nw;
  k.kw = lane - k.g * nw;
  k.mine = w <= kWarp && k.g < (kWarp >> k.lw);
  k.gw = k.mine ? k.g << k.lw : 0;
  // w = 16: bytes 2g, 2g + 1 of two ballots; w = 8: byte g of two ballots
  k.perm = w == 16 ? 0x5410u + 0x2222u * (k.g & 1)
                   : 0x40u + 0x11u * (k.g & 3);
#pragma unroll
  for (int c = 0; c < 4; ++c) k.pick[c] = k.kw == c ? kFull : 0u;
  return k;
}

// The key word this lane builds from the codes its warp holds, one code a
// lane (a pair past the tile's live pairs must hold code 0).  w <= 32: word
// kl.kw of the warp's row kl.g (the lanes that are not kl.mine build
// nothing of use); w > 32: word i * w / 32 + h of lane i < 8, where the
// warp holds segments 32 h .. 32 h + 31 of a row.  Every lane of the warp
// calls it.  W = 0: w (a power of two) at run time, from kl.
template <int W>
__device__ __forceinline__ unsigned ballot_word(const KeyLane& kl, int code,
                                                int bits) {
  static_assert(W == 0 || W == 8 || W == 16 || W == 64,
                "compile-time widths: 8, 16 and 64");
  const int lw = W > 0 ? log2_width(W) : kl.lw;
  const int w = 1 << lw;
  const int lane = threadIdx.x & (kWarp - 1);
  // the code MSB first from bit 31: plane i is bit 31 - i
  const unsigned c = static_cast<unsigned>(code) << (32 - bits);
  unsigned bal[kPlanes];
  plane_ballots(c, bal, std::make_integer_sequence<int, kPlanes>{});
  if (W <= kWarp && w <= kWarp) {
    unsigned t = 0;   // the word LSB first
    if constexpr (W == 16) {
      // row g is bytes 2g, 2g + 1 of each ballot: word c's two planes in
      // one byte permute, then this lane's word by a register select
      t = __byte_perm(bal[0], bal[1], kl.perm);
#pragma unroll
      for (int cw = 1; cw < kPlanes / 2; ++cw)
        t = select_bits(t, __byte_perm(bal[2 * cw], bal[2 * cw + 1], kl.perm),
                        kl.pick[cw]);
    } else if constexpr (W == 8) {
      // row g is byte g of each ballot: word c's four planes in three
      const auto word = [&](int c) {
        return __byte_perm(__byte_perm(bal[4 * c], bal[4 * c + 1], kl.perm),
                           __byte_perm(bal[4 * c + 2], bal[4 * c + 3], kl.perm),
                           0x5410);
      };
      t = select_bits(word(0), word(1), kl.pick[1]);
    } else {
      const unsigned row_mask = kFull >> (kWarp - w);
#pragma unroll
      for (int i = 0; i < kPlanes; ++i) {
        const int bit0 = i << lw;   // the plane's first global key bit
        if ((bit0 >> 5) == kl.kw)
          t |= ((bal[i] >> kl.gw) & row_mask) << (bit0 & 31);
      }
    }
    return __brev(t);
  }
  unsigned plane = 0;
#pragma unroll
  for (int i = 0; i < kPlanes; ++i)
    if (lane == i) plane = bal[i];
  return __brev(plane);
}

// ballot_word and its store, where the warp's lanes hold pairs p of a tile
// (p % 32 is the lane; pairs at or past live_pairs hold code 0 and store
// nothing); keys points at the tile's first row.
template <int W>
__device__ __forceinline__ void ballot_keys(const KeyLane& kl, int code, int p,
                                            int live_pairs, int bits, int nw,
                                            long long* __restrict__ keys) {
  const int lw = W > 0 ? log2_width(W) : kl.lw;
  const int w = 1 << lw;
  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned word = ballot_word<W>(kl, code, bits);
  if (w <= kWarp) {
    const int row = ((p - lane) >> lw) + kl.g;   // the lane's row in the tile
    store_key(keys + row * nw + kl.kw, word,
              kl.mine && (row << lw) < live_pairs);
  } else {
    const int r = p >> lw;
    const int h = (p & (w - 1)) >> 5;
    store_key(keys + r * nw + lane * (w >> 5) + h, word,
              p < live_pairs && lane < bits);
  }
}

// The plane-sh bits (bit sh of each code) of four codes held little-endian
// in x (code k in byte k), MSB first: code 0 at bit 3.  The mask leaves bit
// sh of byte k at bit 8 k; the multiplier (2^31 + 2^22 + 2^13 + 2^4) moves
// it to bit 31 - k, and no two of its sixteen partial products meet.
__host__ __device__ __forceinline__ unsigned plane_nibble(unsigned x, int sh) {
  return (((x >> sh) & 0x01010101u) * 0x80402010u) >> 28;
}

// The key of one row from its w codes, read four at a time: code4(j) holds
// codes j .. j + 3 in bytes 0 .. 3 (a code past the row may read as
// anything: it is shifted out).  The key's bits go out in order through a
// 64-bit buffer, each 32-bit word to store(kw, word) once it is whole, the
// last one left-aligned.  w <= 64 (kWide false): each group of four codes
// is read once and every plane's nibble of it joins that plane's
// accumulator; then the planes are appended, b - 1 first.  kWide: plane by
// plane, re-reading the codes (any w).
template <bool kWide, typename Code4, typename Store>
__device__ __forceinline__ void row_key(Code4 code4, int w, int bits,
                                        Store store) {
  unsigned long long buf = 0;   // key bits not yet stored, the latest at bit 0
  int held = 0;                 // how many: fewer than 32 between appends
  int kw = 0;                   // the next word to store
  const auto append = [&](unsigned v, int n) {   // the n <= 32 low bits of v
    buf = (buf << n) | v;
    held += n;
    if (held >= 32) {
      held -= 32;
      store(kw++, static_cast<unsigned>(buf >> held));
    }
  };
  if constexpr (!kWide) {
    unsigned long long acc[kPlanes] = {};   // acc[s]: bit s of codes 0 .. j
    for (int j = 0; j < w; j += 4) {
      const int take = min(4, w - j);
      const unsigned x = code4(j);
#pragma unroll
      for (int s = 0; s < kPlanes; ++s)
        acc[s] = (acc[s] << take) | (plane_nibble(x, s) >> (4 - take));
    }
#pragma unroll
    for (int s = kPlanes - 1; s >= 0; --s) {
      if (s < bits) {   // plane b - 1 - s
        if (w > 32) append(static_cast<unsigned>(acc[s] >> 32), w - 32);
        append(static_cast<unsigned>(acc[s]), min(w, 32));
      }
    }
  } else {
    for (int s = bits - 1; s >= 0; --s)
      for (int j = 0; j < w; j += 4) {
        const int take = min(4, w - j);
        append(plane_nibble(code4(j), s) >> (4 - take), take);
      }
  }
  if (held > 0) store(kw, static_cast<unsigned>(buf << (32 - held)));
}

}  // namespace coconut
