// One block-bits step for a group of G threads per read (G a power of two
// up to 8: K1, K3 and K15 take 8, K2 and K13 4): the PML step of K1
// `pml_scan`, K2 `pml_classify` and K13 `pml_classify_tp`, and with the
// msrow run ranks K3 `ms_scan` and K15 `ms_scan_tp`'s MS / doc step; and
// the step-late output slots.
//
// The step computes what the plain versions in engine/kernels.py compute
// (engine/blockbits.py::pml_probe, and ms_probe's run rank), from the same
// row layout (blockbits_pml.cuh), but issues every load of the step at
// once: the block's character words and, for K3 / K15, the code's
// run-start words as fixed, unrolled, predicated loads of the widest vector
// (16, 8 or 4 bytes) that the row and msrow strides and offsets keep
// aligned (MsStepLayout), each lane of the group a slice of them, plus the
// occ checkpoint, the up-bit word, the high-byte word (wide rows) and the
// msrow checkpoint. A load past the position's offset is predicated off (no
// traffic); the words are masked by the offset after they land. The lanes'
// in-block ranks and the code at the offset are summed across the group
// with __shfl_xor_sync in one word; every lane then computes the same
// carry.
//
// MsSlots takes the jump-table reads off the chain: step t's lane t % G
// issues jump_t / jump_d at the step's jump id and keeps them with the run
// length; the group stores G consecutive outputs (one coalesced store per
// table) once the next group's first step has issued its row loads, and
// the last, partial group after the read's last step. GroupSlots does the
// same for K1's lengths (and K7 / K9's values).

#pragma once

#include <cstdint>

#include "blockbits_pml.cuh"
#include "sharded.cuh"

namespace spn {

// Words (4, 2 or 1) of the widest load that offsets a, b and c keep
// aligned, with the table's base 16-byte aligned.
constexpr int vec_words(int a, int b, int c) {
  return a % 4 == 0 && b % 4 == 0 && c % 4 == 0   ? 4
         : a % 2 == 0 && b % 2 == 0 && c % 2 == 0 ? 2
                                                  : 1;
}

template <int P, int PACK, bool WIDE, int G>
struct MsStepLayout {
  using Lay = Layout<P, PACK, WIDE>;
  static constexpr int WM = Lay::NSLOTS * (1 + Lay::WPC);  // msrow words
  // words a load: character words (row stride, region start, length) and
  // one code's run-start words (msrow stride, region start, code stride)
  static constexpr int VC = vec_words(Lay::W, Lay::W0, Lay::NWCW);
  static constexpr int VR = vec_words(WM, Lay::NSLOTS, Lay::WPC);
  static constexpr int NCL = Lay::NWCW / VC;  // character loads a step
  static constexpr int NRL = Lay::WPC / VR;   // run-start loads a step
  static constexpr int CPL = (NCL + G - 1) / G;  // ... a lane
  static constexpr int RPL = (NRL + G - 1) / G;
  static_assert(G == 1 || G == 2 || G == 4 || G == 8, "G in {1, 2, 4, 8}");
};

// V words at p (V-word aligned), or zeros without `need` (no load issued).
template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p, bool need,
                                           uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 v = need ? __ldg(reinterpret_cast<const uint4*>(p))
                         : make_uint4(0u, 0u, 0u, 0u);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (V == 2) {
    const uint2 v = need ? __ldg(reinterpret_cast<const uint2*>(p))
                         : make_uint2(0u, 0u);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = need ? __ldg(p) : 0u;
  }
}

// The lanes of this thread's group, for __shfl_xor_sync.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return ((1u << G) - 1u) << ((threadIdx.x & 31u) & ~(G - 1u));
}

// The sum of x over the lanes of this thread's group, in every lane.
template <int G, typename X>
__device__ __forceinline__ X group_sum(X x) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) x += __shfl_xor_sync(group_mask<G>(), x, o, G);
  return x;
}

// The outputs of a group's steps, stored G at a time: the value of output
// j (column -j of `out`) is kept by lane j % G and stored, one coalesced
// store a group, once lane G - 1's output is in; flush() stores the last,
// partial group. Every lane calls put() with the same j.
template <typename T, int G>
struct GroupSlots {
  T* out;
  T v;

  __device__ __forceinline__ void put(long long j, T x, int lane) {
    if ((int)(j & (G - 1)) == lane) v = x;
    if ((j & (G - 1)) == G - 1) out[-(j - (G - 1) + lane)] = v;
  }
  // after the outputs 0 .. n - 1
  __device__ __forceinline__ void flush(long long n, int lane) const {
    const long long j0 = n & ~(long long)(G - 1);
    if (j0 + lane < n) out[-(j0 + lane)] = v;
  }
};

// What one step decides: the new position, the branch and the jump id a
// mismatch takes (with the run ranks; 0 without).
struct MsProbe {
  long long new_pos;
  int jjump;
  bool is_match, empty;
};

// One step of the group at pos for query character qc (code = tab.code[qc])
// on the block's row (block_of(pos)'s, unsharded or from its shard). Equal
// to engine/blockbits.py::pml_probe; with RUNS (K3 / K15) also to
// ms_probe's jump id, from the block's msrow `mrow`, which K1, K2 and K13
// (RUNS false) neither pass nor read.
template <int P, int PACK, bool WIDE, int G, bool RUNS>
__device__ __forceinline__ MsProbe group_probe(
    const uint32_t* __restrict__ row, const uint32_t* __restrict__ mrow,
    const CharTab& tab, const IndexScalars& s, long long pos, int qc,
    int code, int lane) {
  using Lay = Layout<P, PACK, WIDE>;
  using M = MsStepLayout<P, PACK, WIDE, G>;
  const int rk = code < Lay::NSLOTS - 1 ? code : Lay::NSLOTS - 1;
  const int off = (int)(pos & (P - 1));
  const int wsel = off >> Lay::LOGW;  // the character word holding off
  const int wcut = off >> 5;          // the run-start / up-bit word

  // every load of the step, issued together
  uint32_t cw[M::CPL][M::VC];
  uint32_t rw[M::RPL][M::VR];
  const uint32_t* bits = RUNS ? mrow + Lay::NSLOTS + rk * Lay::WPC : mrow;
#pragma unroll
  for (int i = 0; i < M::CPL; ++i) {
    const int q = lane + i * G;
    load_words<M::VC>(row + Lay::W0 + q * M::VC,
                      q < M::NCL && q * M::VC <= wsel, cw[i]);
  }
  if constexpr (RUNS) {
#pragma unroll
    for (int i = 0; i < M::RPL; ++i) {
      const int q = lane + i * G;
      load_words<M::VR>(bits + q * M::VR, q < M::NRL && q * M::VR <= wcut,
                        rw[i]);
    }
  }
  long long cp = (long long)__ldg(row + rk);
  const uint32_t hw = WIDE ? __ldg(row + Lay::H0 + (rk >> 2)) : 0u;
  const uint32_t upw = __ldg(row + Lay::T0 + rk * Lay::WPC + wcut);
  const int mcp = RUNS ? (int)__ldg(mrow + rk) : 0;

  // this lane's share: codes rk before off, the code at off, run starts
  // of rk before off
  const uint32_t pat = (uint32_t)rk * Lay::LSB;
  const int sh = (off & (Lay::PER_WORD - 1)) * PACK;
  int inblock = 0, runs = 0, at = 0;
#pragma unroll
  for (int i = 0; i < M::CPL; ++i) {
#pragma unroll
    for (int k = 0; k < M::VC; ++k) {
      const int wi = (lane + i * G) * M::VC + k;
      const uint32_t m = wi < wsel ? 0xffffffffu
                         : wi == wsel ? (1u << sh) - 1u : 0u;
      inblock += __popc(zero_groups<PACK>(cw[i][k] ^ pat) & m);
      if (wi == wsel)
        at = (int)((cw[i][k] >> sh) & ((1u << PACK) - 1u)) == rk;
    }
  }
  if constexpr (RUNS) {
#pragma unroll
    for (int i = 0; i < M::RPL; ++i) {
#pragma unroll
      for (int k = 0; k < M::VR; ++k) {
        const int wi = (lane + i * G) * M::VR + k;
        const uint32_t m = wi < wcut ? 0xffffffffu
                           : wi == wcut ? (1u << (off & 31)) - 1u : 0u;
        runs += __popc(rw[i][k] & m);
      }
    }
  }
  if (G > 1) {
    // the group's sums, three fields of one word (each sum <= P = 512)
    int x = inblock | runs << 11 | at << 22;
#pragma unroll
    for (int o = 1; o < G; o <<= 1)
      x += __shfl_xor_sync(group_mask<G>(), x, o, G);
    inblock = x & 0x7FF;
    runs = (x >> 11) & 0x7FF;
    at = (x >> 22) & 1;
  }
  bool at_pos = at != 0;

  // the rest is a one-thread step's (engine/blockbits.py::_probe)
  if (WIDE) cp |= (long long)((hw >> ((rk & 3) * 8)) & 0xFFu) << 32;
  int up_bit = (int)((upw >> (off & 31)) & 1u);
  const bool empty = tab.empty[qc] == 1;
  bool is_tq = false;
  if (PACK == 2 && s.term_pos >= 0) {
    // the terminator aliases code term_code at its single position
    const long long blk = pos >> Lay::LOGP;
    const bool at_term_blk = blk == (s.term_pos >> Lay::LOGP);
    const int to = (int)(s.term_pos & (P - 1));
    if (at_term_blk && rk == s.term_code && off > to) inblock -= 1;
    if (at_term_blk && off == to) at_pos = false;
    is_tq = code == kTermCode;
    if (is_tq) {  // terminator query: one run, threshold 0
      inblock = pos > s.term_pos ? 1 : 0;
      at_pos = pos == s.term_pos;
      cp = s.F_term;
      up_bit = 0;
    }
  }
  const long long A = cp + inblock;  // F[c] + rank(pos, c)
  MsProbe p;
  p.is_match = !empty && at_pos;
  p.empty = empty;
  const bool jump_up =
      !empty && !p.is_match && (A >= tab.Fnext[qc] || up_bit);
  p.new_pos = empty ? tab.F[qc] : A - (jump_up ? 1 : 0);
  p.jjump = 0;
  if constexpr (RUNS) {
    // the char-local run rank: msrow checkpoint plus run starts before off
    int jdown = 2 * (tab.run_base[qc] + mcp + runs);
    if (is_tq) jdown = (int)(2 * s.term_runidx);
    // a jump up targets the previous run's END entry (jdown - 1)
    const int jjump = jump_up ? jdown - 1 : jdown;
    p.jjump = jjump < 0 ? 0 : jjump;
  }
  return p;
}

// The shard of row r of a sharded table and its row there: ShardedRows::
// row's arithmetic, with a 32-bit divide where r and rows_per_shard fit in
// 32 bits (the 64-bit divide is a long subroutine, on the step's chain).
struct ShardAt {
  int shard;
  long long local;
};
template <typename T>
__device__ __forceinline__ ShardAt shard_at(const ShardedRows<T>& t,
                                            long long r) {
  const long long s =
      (unsigned long long)(r | t.rows_per_shard) > 0xffffffffull
          ? r / t.rows_per_shard
          : (long long)((unsigned)r / (unsigned)t.rows_per_shard);
  return {(int)s, r - s * t.rows_per_shard};
}

// A jump-table entry, from the table or from its shard.
template <typename T>
__device__ __forceinline__ T take(const T* __restrict__ t, int i) {
  return __ldg(t + i);
}
template <typename T>
__device__ __forceinline__ T take(const ShardedRows<T>& t, int i) {
  const ShardAt a = shard_at(t, i);
  return __ldg(t.p[a.shard] + a.local);
}

// The modes of K3 / K15.
enum MsMode { kMs = 0, kMsDoc = 1, kPmlDoc = 2 };

// A lane's staged step: the jump-table values at its jump id (issued, not
// yet used) and its run length. Output column of step t: out[-t].
template <typename PosT>
struct MsSlots {
  PosT* ov;  // values: forward position len-1-t is ov[-t]
  PosT* od;  // doc ids, or null
  PosT jt;   // jump_t at the staged step (MS modes)
  PosT jd;   // jump_d at the staged step (doc modes)
  int run;
  int mode;

  // Stages a step: its run length, and jump_t / jump_d at its jump id
  // (tables or ShardedRows) where the mode reads them.
  template <typename JT, typename JD>
  __device__ __forceinline__ void stage(int jidx, int run_len,
                                        const JT& jump_t, const JD& jump_d) {
    run = run_len;
    if (mode != kPmlDoc) jt = take(jump_t, jidx);
    if (mode != kMs) jd = (PosT)take(jump_d, jidx);
  }

  // Stores the slot of step t (the caller's lane's).
  __device__ __forceinline__ void store(long long t) const {
    // MS pointers may go negative: the reference's unsigned underflow
    ov[-t] = mode == kPmlDoc ? (PosT)run : (PosT)(jt - (PosT)run);
    if (mode != kMs) od[-t] = jd;
  }
};

}  // namespace spn
