// One backward PML step over the block-bits rows, per thread.
//
// The device counterpart of `_probe` / `pml_probe` (spumoni_tpu_torch/
// engine/blockbits.py), which port spumoni_tpu/engine/blockbits.py::
// _make_probe_fn + make_blockbits_step_fn. Row layout (int32 words, W per
// row):
//
//   [0, NSLOTS)            occ checkpoints cp[code] (u32 low word if WIDE)
//   [W0, W0 + NWCW)        the block's characters, PACK-bit codes
//   [T0, T0 + NSLOTS*WPC)  up-bits, WPC words per code
//   [H0, H0 + NHW)         WIDE only: checkpoint high bytes, 4 per word
//
// A step reads only the words it needs: the checkpoint slot, the char words
// up to the offset, one up-bit word and, in wide mode, one high-byte word.

#pragma once

#include <cstdint>

namespace spn {

constexpr int kMaxSigma = 15;  // code of a character absent from the index
constexpr int kTermCode = 14;  // code of the pack=2 terminator query
constexpr int kTabRows = 256;  // per-character table rows held in shared mem

// Per-character table in shared memory: column k of the [sq, 5] int64 host
// table, rows past sq zero.
struct CharTab {
  int code[kTabRows];
  int empty[kTabRows];
  int run_base[kTabRows];  // char_off of the char (MS / doc tracking only)
  long long F[kTabRows];
  long long Fnext[kTabRows];
};

// Static scalars of the index (BitMeta).
struct IndexScalars {
  long long n;
  long long nb;
  long long term_pos;  // -1 when there is no pack=2 terminator alias
  long long F_term;
  int term_code;
  long long r;            // runs: jump ids EMPTY = 2r, INIT = 2r+1
  long long term_runidx;  // char-grouped run index of the terminator
};

// What one step decides, beyond the new position (the MS / doc step reads
// the branch taken and where).
struct Probe {
  long long new_pos;
  bool is_match, empty, jump_up, is_tq;
};

template <int P, int PACK, bool WIDE>
struct Layout {
  static constexpr int NSLOTS = PACK == 2 ? 4 : 8;
  static constexpr int PER_WORD = 32 / PACK;
  static constexpr int LOGW = PACK == 2 ? 4 : 3;
  static constexpr int LOGP = P == 32 ? 5 : P == 64 ? 6 : P == 128 ? 7
                            : P == 256 ? 8 : 9;
  static constexpr int NWCW = P / PER_WORD;
  static constexpr int WPC = P / 32;
  static constexpr int NHW = WIDE ? (NSLOTS + 3) / 4 : 0;
  static constexpr int W0 = NSLOTS;
  static constexpr int T0 = NSLOTS + NWCW;
  static constexpr int H0 = T0 + NSLOTS * WPC;
  static constexpr int W = H0 + NHW;
  static constexpr uint32_t LSB = PACK == 2 ? 0x55555555u : 0x11111111u;
  static_assert((1 << LOGP) == P, "P must be 32, 64, 128, 256 or 512");
};

// Bit j*PACK of the result is set where code group j of y is all zero.
template <int PACK>
__device__ __forceinline__ uint32_t zero_groups(uint32_t y) {
  uint32_t z = y | (y >> 1);
  if (PACK == 4) z |= (y >> 2) | (y >> 3);
  return ~z & (PACK == 2 ? 0x55555555u : 0x11111111u);
}

// Block of a position, clamped to the rows.
template <int P>
__device__ __forceinline__ long long block_of(const IndexScalars& s,
                                              long long pos) {
  constexpr int LOGP = Layout<P, 2, false>::LOGP;
  const long long blk = pos >> LOGP;
  return blk < 0 ? 0 : blk < s.nb - 1 ? blk : s.nb - 1;
}

// One step's shared math (the probe of PML and MS / doc steps).
template <int P, int PACK, bool WIDE>
__device__ __forceinline__ Probe probe(const uint32_t* __restrict__ rows,
                                       const CharTab& tab,
                                       const IndexScalars& s, long long pos,
                                       int qc) {
  using Lay = Layout<P, PACK, WIDE>;
  const int code = tab.code[qc];
  const bool empty = tab.empty[qc] == 1;
  const int rk = code < Lay::NSLOTS - 1 ? code : Lay::NSLOTS - 1;

  const long long blk = pos >> Lay::LOGP;
  const uint32_t* row = rows + block_of<P>(s, pos) * Lay::W;
  const int off = (int)(pos & (P - 1));

  // in-block rank of code rk over offsets < off
  const uint32_t pat = (uint32_t)rk * Lay::LSB;
  const int wsel = off >> Lay::LOGW;
  int inblock = 0;
  for (int w = 0; w < wsel; ++w)
    inblock += __popc(zero_groups<PACK>(__ldg(row + Lay::W0 + w) ^ pat));
  const uint32_t w_at = __ldg(row + Lay::W0 + wsel);
  const int sh = (off & (Lay::PER_WORD - 1)) * PACK;
  inblock += __popc(zero_groups<PACK>(w_at ^ pat) & ((1u << sh) - 1u));
  bool at_pos = (int)((w_at >> sh) & ((1u << PACK) - 1u)) == rk;

  // occ checkpoint (40-bit in wide mode)
  long long cp = (long long)__ldg(row + rk);
  if (WIDE) {
    const uint32_t hw = __ldg(row + Lay::H0 + (rk >> 2));
    cp |= (long long)((hw >> ((rk & 3) * 8)) & 0xFFu) << 32;
  }
  // up/down bit of code rk at offset off
  const uint32_t upw = __ldg(row + Lay::T0 + rk * Lay::WPC + (off >> 5));
  int up_bit = (int)((upw >> (off & 31)) & 1u);

  bool is_tq = false;
  if (PACK == 2 && s.term_pos >= 0) {
    // the terminator aliases code term_code at its single position
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
  Probe p;
  p.is_match = !empty && at_pos;
  p.empty = empty;
  p.jump_up = !empty && !p.is_match && (A >= tab.Fnext[qc] || up_bit);
  p.is_tq = is_tq;
  p.new_pos = empty ? tab.F[qc] : A - (p.jump_up ? 1 : 0);
  return p;
}

// One PML step: returns the new position and sets is_match.
template <int P, int PACK, bool WIDE>
__device__ __forceinline__ long long pml_step(
    const uint32_t* __restrict__ rows, const CharTab& tab,
    const IndexScalars& s, long long pos, int qc, bool& is_match) {
  const Probe p = probe<P, PACK, WIDE>(rows, tab, s, pos, qc);
  is_match = p.is_match;
  return p.new_pos;
}

// Loads the [sq, 5] int64 host table into shared memory (all threads of the
// block take part; the caller synchronises).
__device__ __forceinline__ void load_char_tab(CharTab& tab,
                                              const long long* __restrict__ t,
                                              int sq) {
  for (int i = threadIdx.x; i < kTabRows; i += blockDim.x) {
    const bool in = i < sq;
    tab.code[i] = in ? (int)t[i * 5 + 0] : 0;
    tab.empty[i] = in ? (int)t[i * 5 + 1] : 0;
    tab.run_base[i] = in ? (int)t[i * 5 + 4] : 0;
    tab.F[i] = in ? t[i * 5 + 2] : 0;
    tab.Fnext[i] = in ? t[i * 5 + 3] : 0;
  }
}

}  // namespace spn
