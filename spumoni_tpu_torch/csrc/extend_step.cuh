// The MS extension of K4 `ms_extend` and K16 `ms_extend_tp` as one walk for
// a group of G threads per read, templated on the text source: a flat text
// (K4) or the text in shards of whole 512-byte rows (K16).
//
// The function is extend_pointers_kernel's two-pointer carry
// (spumoni_tpu/engine/scan_engine.py:1041-1101) on any pointer matrix: a
// walk holds a position i and a carried length l; a test at (i, l) holds
// when i + l < len, ptr[i] >= 0, tpos = ptr[i] + l lies in [0, nt) and
// read[i + l] == text[tpos] (text past ntext reads as 0 up to nt); a test
// that holds adds one to l, one that fails emits l at i and moves to i + 1
// keeping max(l - 1, 0). So a negative pointer emits the carried l.
//
// One thread a read walked up to 3 L dependent iterations, each a random
// text byte behind a pointer load. Here:
//   * the group stages the read's pointer row and bytes in shared memory
//     with 16-byte loads (a scalar head and tail where a row is not 16-byte
//     aligned), and stores the lengths back the same way, over the
//     pointers;
//   * lane k walks positions [k C, (k + 1) C), C = ceil(len / G), from
//     l = 0: its first output is the true extension there, o'. The walk
//     that the carry would make starts at (k C, x), x = max(o[k C - 1] - 1,
//     0). If o' >= x the restarted walk passed through (k C, x), and every
//     later step is the same: the chunk is exact. If o' < x (valid MS
//     pointers never give it) the lane walks its chunk again from x, in
//     lane order, so each lane's check sees its left neighbour's final
//     last output. No input takes another route;
//   * a test compares words, not bytes: one unaligned 16-byte text
//     window a round trip, made from two aligned 16-byte loads by
//     shifts, against the staged read bytes, the first
//     mismatch found with __ffsll of the XOR and capped by len - i - l
//     and nt - tpos. A load past the text's bytes is predicated off and
//     reads as 0, so no load leaves the allocation;
//   * a test at the point where the lane's last comparison stopped fails
//     again without a load: on one diagonal (ptr[i + 1] = ptr[i] + 1, the
//     usual MS case) an emit costs no text round trip at all;
//   * the next pointer is read from shared memory a position ahead.
// Rows that do not fit the block's shared memory (reads of many thousand
// bytes) are walked the same way from device memory (STAGED false).

#pragma once

#include <cstdint>
#include <type_traits>

#include "lanes.cuh"
#include "sharded.cuh"

namespace spn {

// The lanes of this thread's group: one warp (kExtendGroup; time_scan's
// k4-g8 / k4-g16 variants patch in the mask of a smaller group).
template <int G>
__device__ __forceinline__ unsigned extend_mask() {
  static_assert(G == 32, "one warp a read");
  return 0xffffffffu;
}

// Bytes [s / 8, s / 8 + 8) of the 16 little-endian bytes x | y << 64.
__device__ __forceinline__ uint64_t shr128(uint64_t x, uint64_t y, int s) {
  return s ? (x >> s) | (y << (64 - s)) : x;
}

// The number of equal leading bytes of two 16-byte windows (16: all).
__device__ __forceinline__ int first_diff(uint64_t lo, uint64_t hi) {
  if (lo) return (__ffsll((long long)lo) - 1) >> 3;
  if (hi) return 8 + ((__ffsll((long long)hi) - 1) >> 3);
  return 16;
}

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

// K4's text: n bytes at p (16-byte aligned), 0 past them.
struct FlatText {
  const uint8_t* p;
  long long n;

  // The aligned 16 bytes at a (a % 16 == 0, a >= 0).
  __device__ __forceinline__ uint4 word(long long a) const {
    if (a + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(p + a));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    for (int j = 0; j < 16 && a + j < n; ++j)  // the text's last, partial word
      w[j >> 2] |= (uint32_t)__ldg(p + a + j) << (8 * (j & 3));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// K16's text: S shards of rows_per_shard bytes (a multiple of 16, each
// shard 16-byte aligned), n = S * rows_per_shard < 2^36, 0 past them. An
// aligned word never straddles two shards: one shard lookup a word, a
// 32-bit divide of word indices and the shard's pointer picked by
// unrolled compares (ShardedRows::row's 64-bit divide is a subroutine
// call, and its indexed pointer array a copy in local memory).
struct ShardedText {
  ShardedRows<uint8_t> s;
  long long n;

  __device__ __forceinline__ uint4 word(long long a) const {
    if (a >= n) return zero4();
    const unsigned k =
        (unsigned)(a >> 4) / (unsigned)(s.rows_per_shard >> 4);
    const uint8_t* p = s.p[0];
#pragma unroll
    for (int j = 1; j < kMaxShards; ++j)
      if (k == (unsigned)j) p = s.p[j];
    return __ldg(reinterpret_cast<const uint4*>(
        p + (a - (long long)k * s.rows_per_shard)));
  }
};

// The read's bytes staged in shared memory at base + off (base 16-byte
// aligned, 24 bytes readable from the row's last byte on).
struct SharedBytes {
  const uint8_t* base;
  int off;

  __device__ __forceinline__ void get16(long long r, uint64_t& lo,
                                        uint64_t& hi) const {
    const long long k = off + r;
    const uint64_t* q = reinterpret_cast<const uint64_t*>(base) + (k >> 3);
    const int s = (int)(k & 7) * 8;
    const uint64_t c0 = q[0], c1 = q[1], c2 = q[2];
    lo = shr128(c0, c1, s);
    hi = shr128(c1, c2, s);
  }
};

// The read's bytes in device memory (rows too long to stage): byte loads,
// none past the read's len bytes.
struct GlobalBytes {
  const uint8_t* p;
  long long len;

  __device__ __forceinline__ void get16(long long r, uint64_t& lo,
                                        uint64_t& hi) const {
    lo = hi = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint64_t c = r + j < len ? (uint64_t)__ldg(p + r + j) : 0;
      if (j < 8)
        lo |= c << (8 * j);
      else
        hi |= c << (8 * (j - 8));
    }
  }
};

// The text's 16 bytes at t = a + o (o < 16) from the aligned words at a
// and a + 16.
__device__ __forceinline__ void text16(const uint4& w0, const uint4& w1,
                                       int o, uint64_t& lo, uint64_t& hi) {
  const uint64_t a0 = (uint64_t)w0.x | (uint64_t)w0.y << 32;
  const uint64_t a1 = (uint64_t)w0.z | (uint64_t)w0.w << 32;
  const uint64_t b0 = (uint64_t)w1.x | (uint64_t)w1.y << 32;
  const uint64_t b1 = (uint64_t)w1.z | (uint64_t)w1.w << 32;
  const int s = (o & 7) * 8;
  if (o < 8) {
    lo = shr128(a0, a1, s);
    hi = shr128(a1, b0, s);
  } else {
    lo = shr128(a1, b0, s);
    hi = shr128(b0, b1, s);
  }
}

// The number of leading read bytes from r equal to the text from tpos, at
// most cap (> 0): one unaligned 16-byte window a round trip, made from its
// two aligned text words loaded at once (the second not at all past the
// cap).
template <typename Text, typename Bytes>
__device__ __forceinline__ long long match_len(const Text& text,
                                               const Bytes& rd, long long r,
                                               long long tpos,
                                               long long cap) {
  long long m = 0;
  for (;;) {
    const long long t = tpos + m, ta = t & ~15LL;  // t < tpos + cap
    const uint4 w0 = text.word(ta);
    const uint4 w1 = ta + 16 < tpos + cap ? text.word(ta + 16) : zero4();
    uint64_t tlo, thi, rlo, rhi;
    text16(w0, w1, (int)(t & 15), tlo, thi);
    rd.get16(r + m, rlo, rhi);
    const int f = first_diff(tlo ^ rlo, thi ^ rhi);
    if (f >= cap - m) return cap;
    m += f;
    if (f < 16) return m;
  }
}

// One lane's walk over positions [i, e) from carried length l: each
// position's length into out[i] (out may be ptr: a position's pointer is
// read before its length is written); returns the last length.
template <typename PosT, typename Text, typename Bytes>
__device__ __forceinline__ long long extend_walk(const Text& text,
                                                 long long nt,
                                                 const Bytes& rd,
                                                 const PosT* ptr, PosT* out,
                                                 long long len, long long i,
                                                 long long e, long long l) {
  long long stop_r = -1, stop_t = -1;  // where the last comparison failed
  long long last = 0;
  long long p = i < e ? (long long)ptr[i] : 0;
  for (; i < e; ++i) {
    const long long pn = i + 1 < e ? (long long)ptr[i + 1] : 0;
    const long long r = i + l, tpos = p + l;  // p >= 0: tpos >= 0
    if (p >= 0 && r < len && tpos < nt && (r != stop_r || tpos != stop_t)) {
      const long long cap = len - r < nt - tpos ? len - r : nt - tpos;
      const long long m = match_len(text, rd, r, tpos, cap);
      l += m;
      stop_r = r + m;
      stop_t = tpos + m;
    }
    out[i] = (PosT)l;
    last = l;
    l = l > 0 ? l - 1 : 0;
    p = pn;
  }
  return last;
}

// n bytes from src to dst by the G lanes of a group: 16-byte copies where
// dst - src is a multiple of 16 (a scalar head and tail), else elements of
// E (n a multiple of sizeof(E)).
template <int G, typename E>
__device__ __forceinline__ void copy_row(uint8_t* dst, const uint8_t* src,
                                         long long n, int lane) {
  if (((uintptr_t)dst ^ (uintptr_t)src) & 15) {
    E* d = reinterpret_cast<E*>(dst);
    const E* s = reinterpret_cast<const E*>(src);
    for (long long j = lane; j < n / (long long)sizeof(E); j += G) d[j] = s[j];
    return;
  }
  long long head = (16 - (long long)((uintptr_t)src & 15)) & 15;
  head = head < n ? head : n;
  for (long long j = lane; j < head; j += G) dst[j] = src[j];
  const long long nv = (n - head) >> 4;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  for (long long j = lane; j < nv; j += G) d4[j] = s4[j];
  for (long long j = head + (nv << 4) + lane; j < n; j += G) dst[j] = src[j];
}

// Shared memory of one group's row: the pointers (lengths after the walk)
// and the read bytes, each at its device-memory row's offset mod 16 (< 16),
// the bytes with room for a window's three 8-byte loads, 24 bytes from the
// row's last byte on.
template <typename PosT>
__host__ __device__ constexpr long long extend_ptr_bytes(long long L) {
  return (L * (long long)sizeof(PosT) + 31) / 16 * 16;
}
template <typename PosT>
__host__ __device__ constexpr long long extend_row_bytes(long long L) {
  return extend_ptr_bytes<PosT>(L) + (L + 16 + 24 + 15) / 16 * 16;
}

// K4 / K16 for the read of this thread's group: G threads a read, the
// whole group leaves together; the lane's row, length and the offset of its
// pointers and lengths from `lanes` (lanes.cuh). With STAGED, `smem` holds
// the block's rows (extend_row_bytes(lanes.L) each). Lengths over the
// lane's len outputs (those past it are left as they are: the wrapper's
// zeros of a matrix; a grouped launch's flat output has none).
template <int G, bool STAGED, typename PosT, typename Text>
__device__ __forceinline__ void group_extend(
    const Text& text, long long nt, const uint8_t* __restrict__ reads,
    const Lanes& lanes, const PosT* ptrs, PosT* out, uint8_t* smem) {
  static_assert(G == 8 || G == 16 || G == 32, "G in {8, 16, 32}");
  const long long b =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= lanes.B) return;
  const int lane = (int)(threadIdx.x & (G - 1));
  const unsigned mask = extend_mask<G>();
  const long long len = lanes.len(b);
  const uint8_t* rd_g = reads + lanes.row(b);
  const PosT* pp_g = ptrs + lanes.off(b);
  PosT* o_g = out + lanes.off(b);
  PosT* row = o_g;                              // pointers, then lengths
  const PosT* src = pp_g;
  using Bytes = typename std::conditional<STAGED, SharedBytes,
                                          GlobalBytes>::type;
  Bytes rd;
  if constexpr (STAGED) {
    uint8_t* region =
        smem + (threadIdx.x / G) * extend_row_bytes<PosT>(lanes.L);
    row = reinterpret_cast<PosT*>(region + ((uintptr_t)pp_g & 15));
    src = row;
    uint8_t* bytes = region + extend_ptr_bytes<PosT>(lanes.L);
    const int off = (int)((uintptr_t)rd_g & 15);
    copy_row<G, PosT>(reinterpret_cast<uint8_t*>(row),
                      reinterpret_cast<const uint8_t*>(pp_g),
                      len * (long long)sizeof(PosT), lane);
    copy_row<G, uint8_t>(bytes + off, rd_g, len, lane);
    __syncwarp(mask);
    rd = SharedBytes{bytes, off};
  } else {
    rd = GlobalBytes{rd_g, len};
  }
  const long long C = (len + G - 1) / G;
  long long s = lane * C;
  s = s < len ? s : len;
  const long long e = s + C < len ? s + C : len;
  long long last = extend_walk(text, nt, rd, src, row, len, s, e, 0);
  const long long first = s < e ? (long long)row[s] : 0;
  // the carry: lane k's chunk is exact when its restarted first output
  // covers the carry lane k - 1 hands it; else it walks again, in lane
  // order (pointers from device memory: the staged ones are overwritten)
  const long long left = __shfl_up_sync(mask, last, 1, G);
  const bool bad = lane > 0 && s < e && first < (left > 0 ? left - 1 : 0);
  if (__any_sync(mask, bad)) {
    for (int k = 1; k < G; ++k) {
      const long long pl = __shfl_sync(mask, last, k - 1, G);
      const long long x = pl > 0 ? pl - 1 : 0;
      if (lane == k && s < e && first < x)
        last = extend_walk(text, nt, rd, pp_g, row, len, s, e, x);
    }
  }
  if constexpr (STAGED) {
    __syncwarp(mask);
    copy_row<G, PosT>(reinterpret_cast<uint8_t*>(o_g),
                      reinterpret_cast<const uint8_t*>(row),
                      len * (long long)sizeof(PosT), lane);
  }
}

}  // namespace spn
