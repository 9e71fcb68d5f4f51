// The occ-block index's row layout, scalars and carry (engine v3, shared by
// K9 and K10), and one step of K9 `occ_scan` and K10 `occ_classify` for a
// group of G threads per read.
//
// The step computes the JAX step (engine/occblock.py:248-354) from the
// same row, with every load of the step issued at once: the threshold at
// the candidate's offset (the previous step's deferred jump), both sample
// and both doc candidates (the jump's two targets, chosen after the
// threshold lands), the query code's checkpoint, and the character words
// up to the offset, WORDS 4-byte loads a lane (the row stride is odd, so a
// row is only 4-byte aligned; words_per_lane<G>() makes the 17 words of P =
// 128 one round at any G). A word past the offset is predicated off; the
// words are masked after the resolved offset is known, and the lanes'
// counts and the code at the offset are summed across the group with
// __shfl_xor_sync in one word. So a step is one round trip (more only from
// P = 256 on, where the words outgrow a round of G WORDS), where a
// one-thread step makes the threshold, then the sample or doc word and a
// loop of dependent word loads. Every lane carries the same state.

#pragma once

#include <cstdint>

#include "blockbits_pml.cuh"  // spn::CharTab
#include "ms_step.cuh"        // spn::group_sum

namespace spn {
namespace occ {

constexpr int kW0 = 16;  // first char word: after the 16 checkpoints
constexpr uint32_t kNibLsb = 0x11111111u;
// the char words of a row at P = 128: (P + 1 + 7) / 8
constexpr int kWordsP128 = 17;

// Char words a lane loads a round: the words of P = 128 in one round of G
// lanes (G = 8: 3, G = 4: 5).
template <int G>
constexpr int words_per_lane() {
  return (kWordsP128 + G - 1) / G;
}

enum Mode { kPml = 0, kPmlDoc = 1, kMs = 2, kMsDoc = 3 };

struct Scalars {
  long long nb;  // rows
  int P, logP, W, T0, S0, D0;
  int n, last_run_sample, last_run_edoc, first_run_sdoc;
};

// Per-lane carry of occ_initial_state (occblock.py:248-259).
struct Carry {
  int cand, prev_p, length, sample, doc;
  bool pending, forced, was_match, was_empty;
};

__device__ __forceinline__ Carry seed(const Scalars& s) {
  Carry c;
  c.cand = s.n - 1;
  c.prev_p = 0;
  c.length = 0;
  c.sample = s.last_run_sample + 1;  // was_match: resolves to the seed
  c.doc = s.last_run_edoc;
  c.pending = c.forced = c.was_empty = false;
  c.was_match = true;
  return c;
}

// Bit 4j of the result is set where nibble j of y is zero.
__device__ __forceinline__ uint32_t zero_nibbles(uint32_t y) {
  return ~(y | (y >> 1) | (y >> 2) | (y >> 3)) & kNibLsb;
}

// The row of the unresolved candidate, clamped (occblock.py:295-296).
__device__ __forceinline__ const uint32_t* row_of(
    const uint32_t* __restrict__ blocks, const Scalars& s, int cand) {
  long long blk = cand >> s.logP;
  blk = blk < 0 ? 0 : blk < s.nb - 1 ? blk : s.nb - 1;
  return blocks + blk * s.W;
}

// This lane's share of the count of code c in the block's nibbles 1 .. e-1
// (nibble g: g = 0 prevchar, g = j + 1 block offset j) over the words
// w[i] = word base + lane + i G, and whether the nibble e, which one lane's
// words hold, is c (bit 31).
template <int G, int WORDS>
__device__ __forceinline__ uint32_t nibble_share(const uint32_t (&w)[WORDS],
                                                 int base, int lane,
                                                 uint32_t c, int e) {
  const uint32_t pat = c * kNibLsb;
  const int we = e >> 3, sh = (e & 7) * 4;
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    const int q = base + lane + i * G;
    uint32_t m = q < we ? 0xffffffffu : q == we ? (1u << sh) - 1u : 0u;
    if (q == 0) m &= ~1u;  // not the prevchar
    x += __popc(zero_nibbles(w[i] ^ pat) & m);
    if (q == we && ((w[i] >> sh) & 15u) == c) x |= 0x80000000u;
  }
  return x;
}

// One step of the group from the carry's candidate, whose row is `row`:
// resolves the previous step's jump (its sample and doc id) and, unless
// qc < 0 (the resolution after a read's last character), processes
// query-rank code qc; each lane loads WORDS char words a round.
template <int MODE, int G, int WORDS = words_per_lane<G>()>
__device__ __forceinline__ void group_step(const uint32_t* __restrict__ row,
                                           const Scalars& s,
                                           const CharTab& tab, int qc,
                                           int lane, Carry& st, int& sample,
                                           int& doc) {
  constexpr bool kIsMs = MODE == kMs || MODE == kMsDoc;
  constexpr bool kDoc = MODE == kPmlDoc || MODE == kMsDoc;
  const int off = st.cand & (s.P - 1);
  const bool jumped = !st.was_match && !st.was_empty;
  const bool step = qc >= 0 && tab.empty[qc] != 1;
  const uint32_t c = step ? (uint32_t)tab.code[qc] : 0u;
  const int wmax = (off + 1) >> 3;  // the last word the offset may need

  // every load of the step, issued together
  const int thr = st.pending && !st.forced ? (int)__ldg(row + s.T0 + off)
                                           : 0;
  int sc[2] = {0, 0}, dc[2] = {0, 0};
  if (kIsMs && jumped) {
    sc[0] = (int)__ldg(row + s.S0 + off);
    sc[1] = (int)__ldg(row + s.S0 + s.P + off);
  }
  if (kDoc && jumped) {
    dc[0] = (int)__ldg(row + s.D0 + off);
    dc[1] = (int)__ldg(row + s.D0 + s.P + off);
  }
  const int cp = step ? (int)__ldg(row + c) : 0;
  uint32_t w[WORDS];
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    const int q = lane + i * G;
    w[i] = step && q <= wmax ? __ldg(row + kW0 + q) : 0u;
  }

  // resolution of the previous step's jump
  const bool minus1 = st.forced || (st.pending && st.prev_p < thr);
  sample = st.sample;
  if (kIsMs)
    sample = st.was_match ? st.sample - 1
             : st.was_empty ? 0
             : sc[minus1 ? 1 : 0];
  doc = st.doc;
  if (kDoc) {
    if (jumped)
      doc = dc[minus1 ? 1 : 0];
    else if (kIsMs && st.was_empty)  // compute_ms_pml.cpp:639-643
      doc = s.first_run_sdoc;        // (PML keeps the doc: :303)
  }
  if (qc < 0) return;
  st.sample = sample;
  st.doc = doc;

  // advance from the resolved position (block offset pos_off in [-1, P-1])
  const int p = st.cand - minus1, pos_off = off - minus1;
  const bool empty = !step;
  bool is_match = false, has_next = false;
  int cand;
  if (empty) {
    cand = (int)tab.F[qc];
  } else {
    // rank within the block = #{1 <= g <= pos_off : nib[g] == c}, less one
    // where pos_off = -1 and the prevchar is c; bwt[p] = nib[e]
    const int e = pos_off + 1;
    uint32_t x = nibble_share<G, WORDS>(w, 0, lane, c, e);
    for (int base = G * WORDS; base <= wmax; base += G * WORDS) {
      uint32_t v[WORDS];
#pragma unroll
      for (int i = 0; i < WORDS; ++i) {
        const int q = base + lane + i * G;
        v[i] = q <= wmax ? __ldg(row + kW0 + q) : 0u;
      }
      x += nibble_share<G, WORDS>(v, base, lane, c, e);
    }
    x = group_sum<G>(x);
    is_match = (x >> 31) != 0;
    const int cnt = (int)(x & 0x7fffffffu) - (e == 0 && is_match ? 1 : 0);
    cand = cp + cnt;  // F[c] + rank(p, c)
    has_next = (long long)cand < tab.Fnext[qc];
  }
  st.prev_p = p;
  st.cand = cand;
  st.pending = !empty && !is_match && has_next;
  st.forced = !empty && !is_match && !has_next;
  st.length = is_match ? st.length + 1 : 0;
  st.was_match = is_match;
  st.was_empty = empty;
}

}  // namespace occ
}  // namespace spn
