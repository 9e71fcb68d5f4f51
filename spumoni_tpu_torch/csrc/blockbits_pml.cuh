// The block-bits row layout, the index's scalars and the per-character
// table in shared memory: what every block-bits step reads
// (spn::group_probe in ms_step.cuh, for K1, K2, K13, K3 and K15), and the
// table K9 / K10 read too.
//
// The layout is that of `_probe` / `pml_probe` (spumoni_tpu_torch/
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
