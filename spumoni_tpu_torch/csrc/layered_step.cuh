// The layered index's layout and scalars (engine v2, shared by K7, K8 and
// K14), and one step of K7 `layered_scan`, K8 `layered_classify` and K14
// `layered_classify_tp` for a group of G threads per read, templated on
// where a field row comes from (FlatFields: one table, K7 / K8;
// ShardFields: the table in shards, K14).
//
// The step computes the JAX step (engine/layered.py:270-390), from the same
// tables, with the loads of each round trip issued at once and split over
// the group:
//   * a level's 64-entry row is read as 16-byte loads, kRow a lane (2 at
//     int32, 4 at int64 with G = 8); each lane counts its entries <= pos
//     and the group sums the counts with __shfl_xor_sync: the JAX step's
//     compare-count (`jnp.sum(rows <= pos)`), one round trip a level where
//     a one-thread upper-bound search makes up to 7 dependent probes;
//   * the top level's row depends only on the step's character (rank 0),
//     so the caller loads it a step ahead, off the chain;
//   * the field row's slots the mode reads (4, or 8 with samples or doc
//     ids) are loaded at once by every lane of the group (one address: one
//     transaction), and the sample or doc slot is selected after they land.
// So a step is D - 1 level round trips, each followed by a 3-shuffle sum,
// and one field round trip, where it was up to 7 D + 2 dependent loads.
// Every lane carries the same (pos, length, sample, doc).

#pragma once

#include <cstdint>

#include "ms_step.cuh"  // spn::group_sum, spn::shard_at
#include "sharded.cuh"

namespace spn {
namespace layered {

constexpr int kNode = 64;
constexpr int kMaxDepth = 12;
constexpr int kMetaCols = 16;

enum Mode { kPml = 0, kPmlDoc = 1, kMs = 2, kMsDoc = 3 };
enum Field { kStart, kLen, kCum, kThr, kEsamp, kSsamp, kEdoc, kSdoc };

struct Levels {
  const void* p[kMaxDepth];
  long long rows[kMaxDepth];
};

struct Scalars {
  int depth, width;
  long long n, last_run_sample, last_run_edoc, first_run_sdoc;
};

// Per-lane recurrence state.
struct Carry {
  long long pos, length, sample, doc;
};

// 16-byte vectors of K7's group step: a level row split over the G lanes
// (kRow a lane: vectors lane, lane + G, ...) and the field slots the mode
// reads (kField, every lane all of them).
template <typename T, int MODE, int G>
struct GroupLayout {
  static constexpr int kPer = 16 / (int)sizeof(T);  // entries a vector
  static constexpr int kRow = kNode / kPer / G;
  static constexpr int kSlots = MODE == kPml ? 4 : 8;
  static constexpr int kField = kSlots / kPer;
  static_assert(kRow >= 1 && (kNode / kPer) % G == 0,
                "G divides a level row's vectors");
};

// Entry i (0 .. 16 / sizeof(T) - 1) of a 16-byte vector of T.
template <typename T>
__device__ __forceinline__ long long entry(const uint4& v, int i) {
  if constexpr (sizeof(T) == 4) {
    const unsigned w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    return (long long)(int)w;
  } else {
    const unsigned lo = i == 0 ? v.x : v.z, hi = i == 0 ? v.y : v.w;
    return (long long)((unsigned long long)hi << 32 | lo);
  }
}

// This lane's share of the level row at `row` (16-byte aligned).
template <typename T, int MODE, int G>
__device__ __forceinline__ void load_level(
    const T* row, int lane, uint4 (&v)[GroupLayout<T, MODE, G>::kRow]) {
  const uint4* p = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < GroupLayout<T, MODE, G>::kRow; ++i)
    v[i] = __ldg(p + lane + i * G);
}

// Entries of a lane's share that are <= pos.
template <typename T, int N>
__device__ __forceinline__ int lane_count_le(const uint4 (&v)[N],
                                             long long pos) {
  int m = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 16 / (int)sizeof(T); ++k)
      m += entry<T>(v[i], k) <= pos ? 1 : 0;
  return m;
}

// K7 / K8's field rows: one table.
template <typename T>
struct FlatFields {
  const T* p;

  __device__ __forceinline__ const T* row(long long r, int w) const {
    return p + r * w;
  }
};

// K14's field rows: S shards; a row's shard and its row there through
// spn::shard_at (a 32-bit divide where the rows fit). A reference to the
// kernel's parameter: a copy of the pointer array, indexed by shard, would
// live in local memory (a stack frame, one more load on the step's chain).
template <typename T>
struct ShardFields {
  const ShardedRows<T>& s;

  __device__ __forceinline__ const T* row(long long r, int w) const {
    const ShardAt at = shard_at(s, r);
    return s.p[at.shard] + at.local * w;
  }
};

// The top level's row of byte c (the descent's first, rank 0).
template <typename T>
__device__ __forceinline__ const T* top_row(const T (*cm)[kMetaCols],
                                            const T* const* lv,
                                            const long long* lv_rows,
                                            int depth, int c) {
  const int t = depth - 1;
  long long at = (long long)cm[c][4 + t];
  at = at < lv_rows[t] - 1 ? at : lv_rows[t] - 1;
  return lv[t] + at * kNode;
}

// One backward step of make_layered_step_fn for byte c by the group; `top`
// is this lane's share of top_row(c), loaded by the caller; the field rows
// come from `fields` (FlatFields or ShardFields, 16-byte aligned).
template <typename T, int MODE, int G, typename Fields>
__device__ __forceinline__ void group_step(
    const T (*cm)[kMetaCols], const T* const* lv, const long long* lv_rows,
    const Fields& fields, const Scalars& s, int c,
    const uint4 (&top)[GroupLayout<T, MODE, G>::kRow], int lane,
    Carry& st) {
  using Lay = GroupLayout<T, MODE, G>;
  constexpr bool kIsMs = MODE == kMs || MODE == kMsDoc;
  constexpr bool kDoc = MODE == kPmlDoc || MODE == kMsDoc;
  const long long F = cm[c][0], cnt = cm[c][1], lo0 = cm[c][2],
                  hi0 = cm[c][3];
  const long long pos = st.pos;
  // 64-ary descent: rank = index within c of the last run start <= pos;
  // no entry <= pos (dead) is possible only at the top level
  int m = group_sum<G>(lane_count_le<T>(top, pos));
  const bool dead = m == 0;
  long long rank = m > 0 ? m - 1 : 0;
  for (int t = s.depth - 2; t >= 0; --t) {
    long long at = (long long)cm[c][4 + t] + rank;
    at = at < lv_rows[t] - 1 ? at : lv_rows[t] - 1;
    uint4 v[Lay::kRow];
    load_level<T, MODE, G>(lv[t] + at * kNode, lane, v);
    m = group_sum<G>(lane_count_le<T>(v, pos));
    rank = rank * kNode + (m > 0 ? m - 1 : 0);
  }
  // row k+1 holds run k and the next run's targets; the probe stops at
  // row hi0, c's last run: past the BWT (pos = n, after a byte that sorts
  // after every index character) every entry counts, padding too, and the
  // run is c's last, as SPUMONI's upper bound over c's run starts finds
  // it. A dead lane reads row lo0, whose threshold (run lo0's) is 0: the
  // jump down the reference takes when rank(pos, c) == 0
  // (compute_ms_pml.cpp:259-268)
  long long probe = dead ? lo0 : lo0 + rank + 1;
  probe = probe < hi0 ? probe : hi0;
  const uint4* f = reinterpret_cast<const uint4*>(fields.row(probe, s.width));
  uint4 fv[Lay::kField];
#pragma unroll
  for (int i = 0; i < Lay::kField; ++i) fv[i] = __ldg(f + i);
  const auto slot = [&](int k) {
    return entry<T>(fv[k / Lay::kPer], k % Lay::kPer);
  };
  const long long start = slot(kStart), len = slot(kLen), cum = slot(kCum),
                  thr = slot(kThr);
  const bool is_match = !dead && pos < start + len;
  const long long off = pos - start;
  const long long rnk = dead ? 0 : cum + (off < len ? off : len);
  const bool has_next = dead ? cnt > 0 : (rank + 1) < (hi0 - lo0);
  const bool jump_down = !is_match && has_next && pos >= thr;
  const bool empty = cnt == 0;

  st.pos = empty ? F : (is_match || jump_down) ? F + rnk : F + rnk - 1;
  st.length = is_match ? st.length + 1 : 0;
  if constexpr (kIsMs)
    st.sample = empty ? 0
                : is_match ? st.sample - 1
                : jump_down ? slot(kSsamp) : slot(kEsamp);
  if constexpr (kDoc) {
    const long long jumped = jump_down ? slot(kSdoc) : slot(kEdoc);
    if (kIsMs)  // an absent char resets the doc (compute_ms_pml.cpp:639)
      st.doc = empty ? s.first_run_sdoc : is_match ? st.doc : jumped;
    else        // ... and keeps it in PML mode (:303)
      st.doc = (empty || is_match) ? st.doc : jumped;
  }
}

}  // namespace layered
}  // namespace spn
