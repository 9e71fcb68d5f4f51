// K1 `pml_scan`, K2 `pml_classify` and K13 `pml_classify_tp`: the PML
// recurrence over the block-bits rows on NVIDIA Hopper (sm_90a), every
// kernel a lane group per read on one step (spn::group_probe, ms_step.cuh):
// K1 with kGroup = 8 threads per read, K2 and K13 with kClassifyGroup = 4.
//
// Replaces (JAX package, jitted XLA scans on the TPU):
//   K1: spumoni_tpu/engine/scan_engine.py::query_batch_kernel_v4 (the v4
//       step of engine/blockbits.py scanned over the read), plus the
//       per-lane flip of _flip_rows: K1 writes forward order.
//   K2: spumoni_tpu/parallel/mesh.py::fused_classify_kernel (the same scan
//       with the windowed bin-max folded into the carry).
//   K13: spumoni_tpu/parallel/tp.py::TpPmlClassifier._classify_fn, K2 over
//       the sharded index: the rows in S shards (sharded.cuh), a block
//       clamped to the padded row count as the JAX owner-masked read
//       (engine/blockbits.py:707-725) clamps it; pad rows are zero.
// Each equals its plain version in engine/kernels.py (pml_scan_reference,
// pml_classify_reference, pml_classify_tp_reference: the recurrence of
// engine/blockbits.py::pml_probe, and _binmax_fold's carry).
//
// Bound: each step is one DEPENDENT random read of one index row (400 B at
// P = 512, pack = 2) — the next position comes from this row — so a lane
// is a pointer chase and the kernel is latency-bound. At the lanes the runs
// launch (a value batch's reads, 32,768 a report-only batch) the card is
// mostly empty, so the time is the longest chain in round trips. The
// per-character table sits in shared memory; steps past a read's length
// are not run: their outputs are never read (mesh.py:102-111,
// scan_engine.py:1966).
//   K1 runs a value batch's staged groups, of every padded length, in one
//   grouped launch (lanes.cuh): each lane's row, length and output offset
//   come from the batch's lane descriptors, the longest reads first, and
//   the lengths go to one flat output without padding. One launch a group
//   cost the sum over the groups of each group's longest chain; the
//   grouped launch costs the batch's longest.
//   The step is K3's without the msrow run ranks (spn::group_probe, RUNS
//   false): the block's character words up to the offset as fixed,
//   predicated 16-, 8- or 4-byte loads split over the group, issued at
//   once with the checkpoint, up-bit and high-byte words, and summed by
//   shuffle, so a step is one round trip (a one-thread step made up to 31
//   dependent character-word loads at P = 512, pack = 2). Each step's read
//   byte is loaded a step ahead.
//   K1's group stores 8 lengths at once (GroupSlots); 8 lanes are the
//   group K3 / K15, K7 and K9 take.
//   K2 and K13 store nothing but the verdict: every lane carries the
//   windowed bin-max (binmax.cuh) beside (pos, length), and lane 0 writes
//   it, as K8 does on K7's step. Their runs launch them at 32,768 lanes (a
//   report-only batch), where 4 lanes a read beat 8 (PERF.md section 6).
//   K13 is K2's body with each step's row read from its shard through
//   spn::shard_at (a 32-bit divide where the rows fit), as K15 reads its
//   rows: the row source is the only difference.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launch, or kUnsupported for a layout this
// file does not instantiate.

#include <cuda_runtime.h>

#include <cstdint>

#include "binmax.cuh"
#include "blockbits_pml.cuh"
#include "lanes.cuh"
#include "ms_step.cuh"
#include "sharded.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupported = -1;
constexpr int kGroup = 8;          // threads per read of K1
constexpr int kClassifyGroup = 4;  // threads per read of K2 and K13

// K1: a group of G threads per read steps it through spn::group_probe
// without the run ranks, every lane carrying the same (pos, length); the
// group stores G lengths at once (GroupSlots).
template <int P, int PACK, bool WIDE>
__global__ void __launch_bounds__(kThreads)
pml_scan_kernel(const uint32_t* __restrict__ rows,
                const long long* __restrict__ tab_g, int sq,
                const uint8_t* __restrict__ reads, const spn::Lanes lanes,
                int32_t* __restrict__ out, spn::IndexScalars s) {
  constexpr int G = kGroup;
  constexpr int W = spn::Layout<P, PACK, WIDE>::W;
  __shared__ spn::CharTab tab;
  spn::load_char_tab(tab, tab_g, sq);
  __syncthreads();
  const long long b =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= lanes.B) return;  // the whole group leaves together
  const int lane = (int)(threadIdx.x & (G - 1));
  const long long len = lanes.len(b);
  const uint8_t* rd = reads + lanes.row(b);  // reversed read, left-aligned
  // forward position len-1-t: column -t
  spn::GroupSlots<int32_t, G> o = {out + lanes.off(b) + len - 1, 0};
  long long pos = s.n - 1;
  int32_t length = 0;
  int qn = len > 0 ? __ldg(rd) : 0;  // the next step's character ...
  int cn = tab.code[qn];             // ... and its code
  for (long long t = 0; t < len; ++t) {
    const int qc = qn, code = cn;
    if (t + 1 < len) qn = __ldg(rd + t + 1);
    const spn::MsProbe pr = spn::group_probe<P, PACK, WIDE, G, false>(
        rows + spn::block_of<P>(s, pos) * W, nullptr, tab, s, pos, qc, code,
        lane);
    // the next code before the store: after it, nvcc sank the look-up
    // into the next step, whose checkpoint and up-bit loads then waited on
    // it and issued a round trip after the character words (48 registers
    // against 43; 1.134 against 0.881 ms at 8,192 lanes on an H100)
    cn = tab.code[qn];
    length = pr.is_match ? length + 1 : 0;
    o.put(t, length, lane);
    pos = pr.new_pos;
  }
  o.flush(len, lane);
}

// K2's rows: one table.
struct FlatRows {
  const uint32_t* p;

  __device__ __forceinline__ const uint32_t* row(long long blk, int w) const {
    return p + blk * w;
  }
};

// K13's rows: S shards; a block's shard and its row there through
// spn::shard_at, as K15 reads them. A reference to the kernel's parameter:
// a copy of the pointer array, indexed by shard, would live in local
// memory (a 136-byte stack frame, one more load on the step's chain).
struct ShardRows {
  const spn::ShardedRows<uint32_t>& s;

  __device__ __forceinline__ const uint32_t* row(long long blk, int w) const {
    const spn::ShardAt at = spn::shard_at(s, blk);
    return s.p[at.shard] + at.local * w;
  }
};

// K2 / K13: a group of kClassifyGroup threads per read steps it through
// spn::group_probe without the run ranks, every lane carrying the same
// (pos, length) and BinMax; lane 0 writes the verdict.
template <int P, int PACK, bool WIDE, typename Rows>
__device__ __forceinline__ void classify_reads(
    const Rows& rows, const spn::CharTab& tab, const uint8_t* reads,
    const long long* lens, long long B, long long L, long long thr,
    int bin_width, uint8_t* found, int32_t* above, int32_t* below,
    long long* sum_maxes, const spn::IndexScalars& s) {
  constexpr int G = kClassifyGroup;
  constexpr int W = spn::Layout<P, PACK, WIDE>::W;
  const long long b =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= B) return;  // the whole group leaves together
  const int lane = (int)(threadIdx.x & (G - 1));
  const long long len64 = lens[b];
  const int len = (int)(len64 < 0 ? 0 : len64 > L ? L : len64);
  const uint8_t* rd = reads + b * L;  // reversed read, left-aligned
  spn::BinMax bins(len, bin_width, thr);
  long long pos = s.n - 1;
  int length = 0;
  int qn = len > 0 ? __ldg(rd) : 0;  // the next step's character ...
  int cn = tab.code[qn];             // ... and its code
  for (int t = 0; t < len; ++t) {
    const int qc = qn, code = cn;
    if (t + 1 < len) qn = __ldg(rd + t + 1);
    const spn::MsProbe pr = spn::group_probe<P, PACK, WIDE, G, false>(
        rows.row(spn::block_of<P>(s, pos), W), nullptr, tab, s, pos, qc,
        code, lane);
    length = pr.is_match ? length + 1 : 0;
    bins.add(t, length);
    pos = pr.new_pos;
    cn = tab.code[qn];
  }
  if (lane == 0) bins.finish(found + b, above + b, below + b, sum_maxes + b);
}

template <int P, int PACK, bool WIDE>
__global__ void __launch_bounds__(kThreads)
pml_classify_kernel(const uint32_t* __restrict__ rows,
                    const long long* __restrict__ tab_g, int sq,
                    const uint8_t* __restrict__ reads,
                    const long long* __restrict__ lens, long long B,
                    long long L, long long thr, int bin_width,
                    uint8_t* __restrict__ found, int32_t* __restrict__ above,
                    int32_t* __restrict__ below,
                    long long* __restrict__ sum_maxes, spn::IndexScalars s) {
  __shared__ spn::CharTab tab;
  spn::load_char_tab(tab, tab_g, sq);
  __syncthreads();
  classify_reads<P, PACK, WIDE>(FlatRows{rows}, tab, reads, lens, B, L, thr,
                                bin_width, found, above, below, sum_maxes,
                                s);
}

// K13: K2's body over the rows in shards.
template <int P, int PACK, bool WIDE>
__global__ void __launch_bounds__(kThreads)
pml_classify_tp_kernel(const spn::ShardedRows<uint32_t> rows,
                       const long long* __restrict__ tab_g, int sq,
                       const uint8_t* __restrict__ reads,
                       const long long* __restrict__ lens, long long B,
                       long long L, long long thr, int bin_width,
                       uint8_t* __restrict__ found,
                       int32_t* __restrict__ above,
                       int32_t* __restrict__ below,
                       long long* __restrict__ sum_maxes,
                       spn::IndexScalars s) {
  __shared__ spn::CharTab tab;
  spn::load_char_tab(tab, tab_g, sq);
  __syncthreads();
  classify_reads<P, PACK, WIDE>(ShardRows{rows}, tab, reads, lens, B, L,
                                thr, bin_width, found, above, below,
                                sum_maxes, s);
}

struct Args {
  const uint32_t* rows;
  spn::ShardedRows<uint32_t> shards;  // K13: the rows in S shards
  const long long* tab;
  int sq;
  const uint8_t* reads;
  const long long* lens;
  const long long* lane_rows;  // K1: a grouped launch's lanes, or null
  const long long* lane_offs;
  long long B, L;
  int P, pack;
  bool wide;
  spn::IndexScalars s;
  cudaStream_t stream;
  // K1 output
  int32_t* out;
  // K2 parameters and outputs
  long long thr;
  int bin_width;
  uint8_t* found;
  int32_t* above;
  int32_t* below;
  long long* sum_maxes;
};

unsigned grid_of(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

// K1: kGroup threads per read, B * kGroup threads in blocks of kThreads.
template <int P, int PACK, bool WIDE>
void launch_scan(const Args& a) {
  pml_scan_kernel<P, PACK, WIDE>
      <<<grid_of(a.B * kGroup), kThreads, 0, a.stream>>>(
      a.rows, a.tab, a.sq, a.reads,
      spn::Lanes{a.lane_rows, a.lens, a.lane_offs, a.B, a.L}, a.out, a.s);
}

// K2 / K13: kClassifyGroup threads per read.
template <int P, int PACK, bool WIDE>
void launch_classify(const Args& a) {
  pml_classify_kernel<P, PACK, WIDE>
      <<<grid_of(a.B * kClassifyGroup), kThreads, 0, a.stream>>>(
      a.rows, a.tab, a.sq, a.reads, a.lens, a.B, a.L, a.thr, a.bin_width,
      a.found, a.above, a.below, a.sum_maxes, a.s);
}

template <int P, int PACK, bool WIDE>
void launch_classify_tp(const Args& a) {
  pml_classify_tp_kernel<P, PACK, WIDE>
      <<<grid_of(a.B * kClassifyGroup), kThreads, 0, a.stream>>>(
          a.shards, a.tab, a.sq, a.reads, a.lens, a.B, a.L, a.thr,
          a.bin_width, a.found, a.above, a.below, a.sum_maxes, a.s);
}

// Runs FN<P, PACK, WIDE>(a) for the runtime layout; false when the layout
// has no instantiation.
#define SPN_CASE(FN, P_, PACK_, WIDE_)                                 \
  if (a.P == P_ && a.pack == PACK_ && a.wide == WIDE_) {               \
    FN<P_, PACK_, WIDE_>(a);                                           \
    return true;                                                       \
  }
#define SPN_CASES(FN, P_)                                              \
  SPN_CASE(FN, P_, 2, false) SPN_CASE(FN, P_, 2, true)                 \
  SPN_CASE(FN, P_, 4, false) SPN_CASE(FN, P_, 4, true)
#define SPN_DISPATCH(FN)                                               \
  SPN_CASES(FN, 32) SPN_CASES(FN, 64) SPN_CASES(FN, 128)               \
  SPN_CASES(FN, 256) SPN_CASES(FN, 512)

bool dispatch_scan(const Args& a) {
  SPN_DISPATCH(launch_scan)
  return false;
}

bool dispatch_classify(const Args& a) {
  SPN_DISPATCH(launch_classify)
  return false;
}

bool dispatch_classify_tp(const Args& a) {
  SPN_DISPATCH(launch_classify_tp)
  return false;
}

#undef SPN_DISPATCH
#undef SPN_CASES
#undef SPN_CASE

Args common(const void* rows, long long nb, int P, int pack, int wide,
            long long n, long long term_pos, long long F_term, int term_code,
            const void* tab, int sq, const void* reads, const void* lens,
            long long B, long long L, void* stream) {
  Args a = {};
  a.rows = (const uint32_t*)rows;
  a.tab = (const long long*)tab;
  a.sq = sq;
  a.reads = (const uint8_t*)reads;
  a.lens = (const long long*)lens;
  a.B = B;
  a.L = L;
  a.P = P;
  a.pack = pack;
  a.wide = wide != 0;
  a.s.n = n;
  a.s.nb = nb;
  a.s.term_pos = term_pos;
  a.s.F_term = F_term;
  a.s.term_code = term_code;
  a.stream = (cudaStream_t)stream;
  return a;
}

}  // namespace

// K1: lane_rows and lane_offs null for a [B, L] matrix, else a grouped
// launch's B lanes over the flat rows at `reads`, L the widest row
// (spn::Lanes).
extern "C" int spn_pml_scan(const void* rows, long long nb, int P, int pack,
                            int wide, long long n, long long term_pos,
                            long long F_term, int term_code, const void* tab,
                            int sq, const void* reads, const void* lens,
                            const void* lane_rows, const void* lane_offs,
                            long long B, long long L, void* out,
                            void* stream) {
  if (B == 0) return 0;
  if ((lane_rows == nullptr) != (lane_offs == nullptr)) return kUnsupported;
  Args a = common(rows, nb, P, pack, wide, n, term_pos, F_term, term_code,
                  tab, sq, reads, lens, B, L, stream);
  a.lane_rows = (const long long*)lane_rows;
  a.lane_offs = (const long long*)lane_offs;
  a.out = (int32_t*)out;
  return dispatch_scan(a) ? (int)cudaGetLastError() : kUnsupported;
}

extern "C" int spn_pml_classify(const void* rows, long long nb, int P,
                                int pack, int wide, long long n,
                                long long term_pos, long long F_term,
                                int term_code, const void* tab, int sq,
                                const void* reads, const void* lens,
                                long long B, long long L, long long thr,
                                int bin_width, void* found, void* above,
                                void* below, void* sum_maxes, void* stream) {
  if (B == 0) return 0;
  Args a = common(rows, nb, P, pack, wide, n, term_pos, F_term, term_code,
                  tab, sq, reads, lens, B, L, stream);
  a.thr = thr;
  a.bin_width = bin_width;
  a.found = (uint8_t*)found;
  a.above = (int32_t*)above;
  a.below = (int32_t*)below;
  a.sum_maxes = (long long*)sum_maxes;
  return dispatch_classify(a) ? (int)cudaGetLastError() : kUnsupported;
}

// K13: shard_ptrs is a host array of S shard pointers, each shard
// rows_per_shard rows; nb = S * rows_per_shard, the padded row count.
extern "C" int spn_pml_classify_tp(const void* shard_ptrs, int S,
                                   long long rows_per_shard, long long nb,
                                   int P, int pack, int wide, long long n,
                                   long long term_pos, long long F_term,
                                   int term_code, const void* tab, int sq,
                                   const void* reads, const void* lens,
                                   long long B, long long L, long long thr,
                                   int bin_width, void* found, void* above,
                                   void* below, void* sum_maxes,
                                   void* stream) {
  if (B == 0) return 0;
  Args a = common(nullptr, nb, P, pack, wide, n, term_pos, F_term, term_code,
                  tab, sq, reads, lens, B, L, stream);
  if (!spn::sharded_rows(a.shards, shard_ptrs, S, rows_per_shard) ||
      nb != S * rows_per_shard)
    return kUnsupported;
  a.thr = thr;
  a.bin_width = bin_width;
  a.found = (uint8_t*)found;
  a.above = (int32_t*)above;
  a.below = (int32_t*)below;
  a.sum_maxes = (long long*)sum_maxes;
  return dispatch_classify_tp(a) ? (int)cudaGetLastError() : kUnsupported;
}
