// K3 `ms_scan`, K4 `ms_extend`, K5 `binmax_values`, and K15 `ms_scan_tp` and
// K16 `ms_extend_tp`: matching statistics and document tracking over the
// block-bits rows, on NVIDIA Hopper (sm_90a).
//
// Replaces (JAX package, jitted XLA on the TPU):
//   K3: spumoni_tpu/engine/scan_engine.py::query_batch_kernel_v4ms (the
//       v4-MS / doc step of engine/blockbits.py::make_blockbits_ms_step_fn
//       scanned over the read) and its jump-table reconstruction
//       _take_flat_rows: K3 writes the reconstructed values in forward
//       order as it goes.
//   K4: scan_engine.py::extend_pointers_kernel (the two-pointer extension)
//       and, for ordinary reads, extend_pointers_sweep, which computes the
//       same lengths in bulk passes shaped for the TPU.
//   K5: scan_engine.py::binmax_values_kernel (bin-max over a value matrix).
//   K15: spumoni_tpu/parallel/tp.py::TpMsQuery._query_fn's scan and jump
//       table reads: K3 over the sharded index (sharded.cuh): rows and
//       msrows in S shards of the same rows_per_shard, a block clamped to
//       the padded row count (engine/blockbits.py:707-725; pad rows are
//       zero), jump_t and jump_d in S shards of their own
//       (parallel/tp.py:242-252).
//   K16: the same query's extension over the sharded text
//       (engine/scan_engine.py:563-578, 724-734): K4 with the text in S
//       shards of whole 512-byte rows, zero past the text.
//
// Bounds and design:
//   K3 is a dependent chase: step t's row and msrow are those of the
//   block holding the position step t-1 computed. What bounds it on the
//   H100 is the latency of that chain, and at the lane counts the runs
//   launch (a value batch's reads, 32,768 a report-only batch) the card
//   is mostly empty. The first design, one thread per read with a loop
//   over the char words and one over the run-start words before the
//   offset, ran each step as up to 16 dependent L1 / L2 round trips: ptxas
//   reuses two registers through the unrolled loops. So each step now
//   (csrc/ms_step.cuh) issues all its loads at once: the char region and
//   the code's run-start words as fixed, unrolled, predicated loads of
//   16 bytes (8 and 4 of them at P = 512, pack = 2; 8 or 4 bytes where the
//   layout's row or msrow stride or offsets are not 16-byte aligned), a
//   load past the offset predicated off, plus the checkpoint, up-bit,
//   high-byte and msrow checkpoint words. kGroup = 8 threads per read
//   split those loads, and sum the two in-block ranks and the code at the
//   offset with __shfl_xor_sync; every lane carries the same (pos, jump
//   id, run). G = 8 was the fastest of 1, 2, 4 and 8 at every lane count
//   the runs launch (8,192 and 32,768) and at 65,536, and no run launches
//   more, so only G = 8 is built. The jump-table reads leave the chain:
//   step t's lane t % G reads jump_t / jump_d at the step's jump id, and
//   the group stores G consecutive outputs at once after the next step's
//   row loads have issued (the last, partial group after the read). The
//   mode is a runtime argument.
//   K4 is bound by the latency of its text reads: each is a random access
//   into the ~92 MB text, past the 50 MB L2, and the carry chains them
//   (one thread per read walked up to 3 L dependent compares, each behind
//   a pointer load). K4 and K16 run one group walk (csrc/extend_step.cuh,
//   spn::group_extend) that keeps extend_pointers_kernel's carry on any
//   pointer matrix: kExtendGroup = 32 threads a read, each walking a chunk
//   of the read from the pointers and bytes the group staged in shared
//   memory, 16 text bytes a compare, then an exact lane-order fix-up of
//   the chunks' carries. 32 was the fastest of 8, 16 and 32 at the lanes
//   the runs launch (8,192 and 32,768) and at 65,536, and one 16-byte
//   window a round trip beat two (time_scan's k4-w2), so only these are
//   built.
//   K3 and K4 run a value batch's staged groups, of every padded length,
//   in one grouped launch each (lanes.cuh): each lane's row, length and
//   output offset come from the batch's lane descriptors, the longest
//   reads first, and the values go to flat outputs without padding (K4
//   reads K3's pointers there). One launch a group cost the sum over the
//   groups of each group's longest chain; the grouped launch costs the
//   batch's longest. K4 stages a grouped launch's rows in shared memory
//   only where its longest lane fits, as it does a matrix's widest row.
//   K5 is one warp per read: coalesced reads of the value row, a warp max
//   per bin. Bandwidth-bound on the [B, L] matrix.
//   K15 / K16 are K3 / K4's bodies with each table read from its shard:
//   K15 takes K3's step (ms_step.cuh) on the shard's row and msrow, one
//   divide more per read, no collective; K16 takes K4's walk on the text's
//   shards, one 32-bit divide a 16-byte word.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launch, or kUnsupported for arguments this
// file does not instantiate.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "blockbits_pml.cuh"
#include "extend_step.cuh"
#include "lanes.cuh"
#include "ms_step.cuh"
#include "sharded.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupported = -1;
constexpr int kGroup = 8;  // threads per read of K3 / K15
constexpr int kExtendGroup = 32;  // threads per read of K4 / K16

template <bool WIDE>
using PosOf = typename std::conditional<WIDE, long long, int32_t>::type;

// K3: a group of G threads per read steps it through spn::group_probe, every
// lane carrying the same (pos, jump id, run); lane t % G reads step t's
// jump-table entries, and the group stores G outputs at once a step later.
template <int P, int PACK, bool WIDE>
__global__ void __launch_bounds__(kThreads)
ms_scan_kernel(const uint32_t* __restrict__ rows,
               const uint32_t* __restrict__ msrows,
               const long long* __restrict__ tab_g, int sq,
               const uint8_t* __restrict__ reads, const spn::Lanes lanes,
               const PosOf<WIDE>* __restrict__ jump_t,
               const int32_t* __restrict__ jump_d, PosOf<WIDE>* vals,
               PosOf<WIDE>* docs, spn::IndexScalars s, int mode) {
  using PosT = PosOf<WIDE>;
  constexpr int G = kGroup;
  constexpr int W = spn::Layout<P, PACK, WIDE>::W;
  constexpr int WM = spn::MsStepLayout<P, PACK, WIDE, G>::WM;
  __shared__ spn::CharTab tab;
  spn::load_char_tab(tab, tab_g, sq);
  __syncthreads();
  const long long b =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= lanes.B) return;  // the whole group leaves together
  const int lane = (int)(threadIdx.x & (G - 1));
  const long long len = lanes.len(b);
  const uint8_t* rd = reads + lanes.row(b);  // reversed read, left-aligned
  const long long o = lanes.off(b) + len - 1;
  spn::MsSlots<PosT> out = {vals + o, docs ? docs + o : nullptr, 0, 0, 0,
                            mode};
  const int empty_id = (int)(2 * s.r);  // EMPTY; INIT is 2r+1
  long long pos = s.n - 1;
  int jidx = empty_id + 1;
  int run = 0;  // MS: matches since the last jump (d); PML: the length
  int qn = len > 0 ? __ldg(rd) : 0;  // the next step's character ...
  int cn = tab.code[qn];             // ... and its code
  for (long long t = 0; t < len; ++t) {
    const int qc = qn, code = cn;
    if (t + 1 < len) qn = __ldg(rd + t + 1);
    const long long blk = spn::block_of<P>(s, pos);
    const spn::MsProbe pr = spn::group_probe<P, PACK, WIDE, G, true>(
        rows + blk * W, msrows + blk * WM, tab, s, pos, qc, code, lane);
    // the last group's outputs, after this step's row loads
    if (t > 0 && (t & (G - 1)) == 0) out.store(t - G + lane);
    if (mode == spn::kPmlDoc) {
      // an absent character KEEPS the doc (compute_ms_pml.cpp:303)
      if (!pr.is_match && !pr.empty) jidx = pr.jjump;
    } else if (!pr.is_match) {
      jidx = pr.empty ? empty_id : pr.jjump;  // absent: EMPTY (:639-643)
    }
    run = pr.is_match ? run + 1 : 0;
    if ((t & (G - 1)) == lane) out.stage(jidx, run, jump_t, jump_d);
    pos = pr.new_pos;
    cn = tab.code[qn];
  }
  const long long last = len > 0 ? (len - 1) / G * G + lane : len;
  if (last < len) out.store(last);
}

// K4: spn::group_extend over the flat text, kExtendGroup threads a read;
// STAGED: the block's rows in dynamic shared memory.
template <typename PosT, bool STAGED>
__global__ void __launch_bounds__(kThreads)
ms_extend_kernel(const uint8_t* __restrict__ text, long long ntext,
                 long long nt, const uint8_t* __restrict__ reads,
                 const spn::Lanes lanes, const PosT* ptrs, PosT* out) {
  extern __shared__ __align__(16) uint8_t extend_smem[];
  spn::group_extend<kExtendGroup, STAGED>(
      spn::FlatText{text, ntext}, nt, reads, lanes, ptrs, out, extend_smem);
}

// K15: K3 with the tables in shards: the step's row and msrow from their
// shard (spn::shard_at), each jump-table entry from its own.
template <int P, int PACK, bool WIDE>
__global__ void __launch_bounds__(kThreads)
ms_scan_tp_kernel(const spn::ShardedRows<uint32_t> rows,
                  const spn::ShardedRows<uint32_t> msrows,
                  const long long* __restrict__ tab_g, int sq,
                  const uint8_t* __restrict__ reads,
                  const long long* __restrict__ lens, long long B,
                  long long L, const spn::ShardedRows<PosOf<WIDE>> jump_t,
                  const spn::ShardedRows<int32_t> jump_d, PosOf<WIDE>* vals,
                  PosOf<WIDE>* docs, spn::IndexScalars s, int mode) {
  using PosT = PosOf<WIDE>;
  constexpr int G = kGroup;
  constexpr int W = spn::Layout<P, PACK, WIDE>::W;
  constexpr int WM = spn::MsStepLayout<P, PACK, WIDE, G>::WM;
  __shared__ spn::CharTab tab;
  spn::load_char_tab(tab, tab_g, sq);
  __syncthreads();
  const long long b =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= B) return;  // the whole group leaves together
  const int lane = (int)(threadIdx.x & (G - 1));
  long long len = lens[b];
  len = len < 0 ? 0 : len > L ? L : len;
  const uint8_t* rd = reads + b * L;  // reversed read, left-aligned
  spn::MsSlots<PosT> out = {vals + b * L + len - 1,
                            docs ? docs + b * L + len - 1 : nullptr, 0, 0,
                            0, mode};
  const int empty_id = (int)(2 * s.r);  // EMPTY; INIT is 2r+1
  long long pos = s.n - 1;
  int jidx = empty_id + 1;
  int run = 0;  // MS: matches since the last jump (d); PML: the length
  int qn = len > 0 ? __ldg(rd) : 0;  // the next step's character ...
  int cn = tab.code[qn];             // ... and its code
  for (long long t = 0; t < len; ++t) {
    const int qc = qn, code = cn;
    if (t + 1 < len) qn = __ldg(rd + t + 1);
    // rows and msrows share rows_per_shard: one shard lookup for both
    const spn::ShardAt at = spn::shard_at(rows, spn::block_of<P>(s, pos));
    const spn::MsProbe pr = spn::group_probe<P, PACK, WIDE, G, true>(
        rows.p[at.shard] + at.local * W, msrows.p[at.shard] + at.local * WM,
        tab, s, pos, qc, code, lane);
    // the last group's outputs, after this step's row loads
    if (t > 0 && (t & (G - 1)) == 0) out.store(t - G + lane);
    if (mode == spn::kPmlDoc) {
      // an absent character KEEPS the doc (compute_ms_pml.cpp:303)
      if (!pr.is_match && !pr.empty) jidx = pr.jjump;
    } else if (!pr.is_match) {
      jidx = pr.empty ? empty_id : pr.jjump;  // absent: EMPTY (:639-643)
    }
    run = pr.is_match ? run + 1 : 0;
    if ((t & (G - 1)) == lane) out.stage(jidx, run, jump_t, jump_d);
    pos = pr.new_pos;
    cn = tab.code[qn];
  }
  const long long last = len > 0 ? (len - 1) / G * G + lane : len;
  if (last < len) out.store(last);
}

// K16: K4's walk over the text in shards.
template <typename PosT, bool STAGED>
__global__ void __launch_bounds__(kThreads)
ms_extend_tp_kernel(const spn::ShardedRows<uint8_t> text, long long ntext,
                    long long nt, const uint8_t* __restrict__ reads,
                    const long long* __restrict__ lens, const PosT* ptrs,
                    long long B, long long L, PosT* out) {
  extern __shared__ __align__(16) uint8_t extend_smem[];
  spn::group_extend<kExtendGroup, STAGED>(
      spn::ShardedText{text, ntext}, nt, reads,
      spn::Lanes{nullptr, lens, nullptr, B, L}, ptrs, out, extend_smem);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
binmax_values_kernel(const V* __restrict__ vals,
                     const long long* __restrict__ lens, long long B,
                     long long L, long long thr, int bin_width,
                     uint8_t* __restrict__ found, int32_t* __restrict__ above,
                     int32_t* __restrict__ below,
                     long long* __restrict__ sum_maxes) {
  const long long b =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // the whole warp leaves together
  const long long len = lens[b];
  const long long lenc = len < 0 ? 0 : len > L ? L : len;
  long long nbins = len / bin_width;
  nbins = nbins < 1 ? 1 : nbins;
  const V* v = vals + b * L;
  int n_above = 0;
  long long sum = 0;
  for (long long j = 0; j < nbins; ++j) {
    // the short tail merges into the last bin
    const long long lo = j * bin_width;
    long long hi = j == nbins - 1 ? lenc : lo + bin_width;
    hi = hi < lenc ? hi : lenc;
    long long mx = -1;
    for (long long p = lo + lane; p < hi; p += 32) {
      const long long x = (long long)v[p];
      mx = x > mx ? x : mx;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const long long y = __shfl_xor_sync(0xffffffffu, mx, o);
      mx = y > mx ? y : mx;
    }
    if (mx >= 0) {
      if (mx >= thr) ++n_above;
      sum += mx;
    }
  }
  if (lane == 0) {
    const long long n_below = nbins - n_above;
    found[b] = (n_above > n_below && len > 0) ? 1 : 0;
    above[b] = n_above;
    below[b] = (int32_t)n_below;
    sum_maxes[b] = sum;
  }
}

struct ScanArgs {
  const uint32_t* rows;
  const uint32_t* msrows;
  const long long* tab;
  int sq;
  const uint8_t* reads;
  const long long* lens;
  const long long* lane_rows;  // K3: a grouped launch's lanes, or null
  const long long* lane_offs;
  long long B, L;
  int P, pack, mode;
  bool wide;
  const void* jump_t;
  const int32_t* jump_d;
  void* vals;
  void* docs;
  spn::IndexScalars s;
  cudaStream_t stream;
  // K15: the same tables in S shards (rows and msrows share rows_per_shard)
  bool sharded;
  spn::ShardedRows<uint32_t> rows_s, msrows_s;
  spn::ShardedRows<char> jump_t_s;
  spn::ShardedRows<int32_t> jump_d_s;
};

unsigned grid_of(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

// K3 / K15: kGroup threads per read, B * kGroup threads in blocks of
// kThreads.
template <int P, int PACK, bool WIDE>
bool launch_scan(const ScanArgs& a) {
  using PosT = PosOf<WIDE>;
  if (a.mode < spn::kMs || a.mode > spn::kPmlDoc) return false;
  const unsigned grid = grid_of(a.B * kGroup);
  if (a.sharded) {
    ms_scan_tp_kernel<P, PACK, WIDE><<<grid, kThreads, 0, a.stream>>>(
        a.rows_s, a.msrows_s, a.tab, a.sq, a.reads, a.lens, a.B, a.L,
        spn::retype<PosT>(a.jump_t_s), a.jump_d_s, (PosT*)a.vals,
        (PosT*)a.docs, a.s, a.mode);
    return true;
  }
  ms_scan_kernel<P, PACK, WIDE><<<grid, kThreads, 0, a.stream>>>(
      a.rows, a.msrows, a.tab, a.sq, a.reads,
      spn::Lanes{a.lane_rows, a.lens, a.lane_offs, a.B, a.L},
      (const PosT*)a.jump_t, a.jump_d, (PosT*)a.vals, (PosT*)a.docs, a.s,
      a.mode);
  return true;
}

#define SPN_CASE(P_, PACK_, WIDE_)                                     \
  if (a.P == P_ && a.pack == PACK_ && a.wide == WIDE_)                 \
    return launch_scan<P_, PACK_, WIDE_>(a);
#define SPN_CASES(P_)                                                  \
  SPN_CASE(P_, 2, false) SPN_CASE(P_, 2, true)                         \
  SPN_CASE(P_, 4, false) SPN_CASE(P_, 4, true)

bool dispatch_scan(const ScanArgs& a) {
  SPN_CASES(32) SPN_CASES(64) SPN_CASES(128) SPN_CASES(256) SPN_CASES(512)
  return false;
}

#undef SPN_CASES
#undef SPN_CASE

}  // namespace

namespace {

// The arguments of K3 and K15 but the tables.
ScanArgs scan_args(long long nb, int P, int pack, int wide, long long n,
                   long long term_pos, long long F_term, int term_code,
                   long long r, long long term_runidx, const void* tab,
                   int sq, const void* reads, const void* lens, long long B,
                   long long L, int mode, void* vals,
                   void* docs, void* stream) {
  ScanArgs a = {};
  a.tab = (const long long*)tab;
  a.sq = sq;
  a.reads = (const uint8_t*)reads;
  a.lens = (const long long*)lens;
  a.B = B;
  a.L = L;
  a.P = P;
  a.pack = pack;
  a.mode = mode;
  a.wide = wide != 0;
  a.vals = vals;
  a.docs = docs;
  a.s.n = n;
  a.s.nb = nb;
  a.s.term_pos = term_pos;
  a.s.F_term = F_term;
  a.s.term_code = term_code;
  a.s.r = r;
  a.s.term_runidx = term_runidx;
  a.stream = (cudaStream_t)stream;
  return a;
}

}  // namespace

// K3: lane_rows and lane_offs null for a [B, L] matrix, else a grouped
// launch's B lanes over the flat rows at `reads`, L the widest row
// (spn::Lanes).
extern "C" int spn_ms_scan(const void* rows, const void* msrows, long long nb,
                           int P, int pack, int wide, long long n,
                           long long term_pos, long long F_term,
                           int term_code, long long r, long long term_runidx,
                           const void* tab, int sq, const void* reads,
                           const void* lens, const void* lane_rows,
                           const void* lane_offs, long long B, long long L,
                           const void* jump_t, const void* jump_d, int mode,
                           void* vals, void* docs, void* stream) {
  if (B == 0) return 0;
  if ((lane_rows == nullptr) != (lane_offs == nullptr)) return kUnsupported;
  ScanArgs a = scan_args(nb, P, pack, wide, n, term_pos, F_term, term_code,
                         r, term_runidx, tab, sq, reads, lens, B, L, mode,
                         vals, docs, stream);
  a.lane_rows = (const long long*)lane_rows;
  a.lane_offs = (const long long*)lane_offs;
  a.rows = (const uint32_t*)rows;
  a.msrows = (const uint32_t*)msrows;
  a.jump_t = jump_t;
  a.jump_d = (const int32_t*)jump_d;
  return dispatch_scan(a) ? (int)cudaGetLastError() : kUnsupported;
}

// K15: each table's shards as a host array of S pointers; rows and msrows
// hold rows_per_shard rows a shard (nb = S * rows_per_shard, the padded
// row count), jump_t and jump_d jump_per_shard entries (jump_d's array may
// be null without doc ids).
extern "C" int spn_ms_scan_tp(const void* rows, const void* msrows, int S,
                              long long rows_per_shard, long long nb, int P,
                              int pack, int wide, long long n,
                              long long term_pos, long long F_term,
                              int term_code, long long r,
                              long long term_runidx, const void* tab, int sq,
                              const void* reads, const void* lens,
                              long long B, long long L, const void* jump_t,
                              const void* jump_d, long long jump_per_shard,
                              int mode, void* vals, void* docs,
                              void* stream) {
  if (B == 0) return 0;
  ScanArgs a = scan_args(nb, P, pack, wide, n, term_pos, F_term, term_code,
                         r, term_runidx, tab, sq, reads, lens, B, L, mode,
                         vals, docs, stream);
  a.sharded = true;
  if (nb != S * rows_per_shard ||
      !spn::sharded_rows(a.rows_s, rows, S, rows_per_shard) ||
      !spn::sharded_rows(a.msrows_s, msrows, S, rows_per_shard) ||
      (jump_t && !spn::sharded_rows(a.jump_t_s, jump_t, S, jump_per_shard)) ||
      (jump_d && !spn::sharded_rows(a.jump_d_s, jump_d, S, jump_per_shard)))
    return kUnsupported;
  return dispatch_scan(a) ? (int)cudaGetLastError() : kUnsupported;
}

namespace {

// K4 / K16: B groups of kExtendGroup threads in blocks of kThreads, each
// group's row staged in dynamic shared memory (`staged`) when the block's
// rows fit the card's opt-in limit, else walked from device memory
// (`direct`).
template <typename PosT, typename Kernel, typename... Args>
int launch_extend(Kernel staged, Kernel direct, long long B, long long L,
                  cudaStream_t st, Args... args) {
  const long long smem =
      spn::extend_row_bytes<PosT>(L) * (kThreads / kExtendGroup);
  int dev = 0, optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned grid = grid_of(B * kExtendGroup);
  if (smem > optin) {
    direct<<<grid, kThreads, 0, st>>>(args...);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(staged,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  staged<<<grid, kThreads, (size_t)smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: text 16-byte aligned, ntext bytes; lane_rows and lane_offs null for
// [B, L] matrices of reads, pointers and lengths, else a grouped launch's B
// lanes over the flat rows at `reads`, with the pointers and lengths at
// each lane's output offset, L the longest lane (spn::Lanes).
extern "C" int spn_ms_extend(const void* text, long long ntext, long long nt,
                             const void* reads, const void* lens,
                             const void* lane_rows, const void* lane_offs,
                             const void* ptrs, long long B, long long L,
                             int wide, void* out, void* stream) {
  if (B == 0) return 0;
  if ((lane_rows == nullptr) != (lane_offs == nullptr)) return kUnsupported;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* t = (const uint8_t*)text;
  const uint8_t* rd = (const uint8_t*)reads;
  const spn::Lanes lanes{(const long long*)lane_rows, (const long long*)lens,
                         (const long long*)lane_offs, B, L};
  if (wide)
    return launch_extend<long long>(
        ms_extend_kernel<long long, true>, ms_extend_kernel<long long, false>,
        B, L, st, t, ntext, nt, rd, lanes, (const long long*)ptrs,
        (long long*)out);
  return launch_extend<int32_t>(
      ms_extend_kernel<int32_t, true>, ms_extend_kernel<int32_t, false>, B,
      L, st, t, ntext, nt, rd, lanes, (const int32_t*)ptrs, (int32_t*)out);
}

// K16: the text as a host array of S shard pointers of bytes_per_shard
// bytes each (a multiple of 16, each shard 16-byte aligned), zero past the
// text; ntext = S * bytes_per_shard < 2^36 (16-byte words counted in 32
// bits).
extern "C" int spn_ms_extend_tp(const void* text, int S,
                                long long bytes_per_shard, long long nt,
                                const void* reads, const void* lens,
                                const void* ptrs, long long B, long long L,
                                int wide, void* out, void* stream) {
  if (B == 0) return 0;
  spn::ShardedRows<uint8_t> shards;
  const long long ntext = S * bytes_per_shard;
  if (bytes_per_shard % 16 || (ntext >> 36) ||
      !spn::sharded_rows(shards, text, S, bytes_per_shard))
    return kUnsupported;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* rd = (const uint8_t*)reads;
  const long long* ln = (const long long*)lens;
  if (wide)
    return launch_extend<long long>(
        ms_extend_tp_kernel<long long, true>,
        ms_extend_tp_kernel<long long, false>, B, L, st, shards, ntext, nt,
        rd, ln, (const long long*)ptrs, B, L, (long long*)out);
  return launch_extend<int32_t>(
      ms_extend_tp_kernel<int32_t, true>, ms_extend_tp_kernel<int32_t, false>,
      B, L, st, shards, ntext, nt, rd, ln, (const int32_t*)ptrs, B, L,
      (int32_t*)out);
}

extern "C" int spn_binmax_values(const void* vals, const void* lens,
                                 long long B, long long L, int wide,
                                 long long thr, int bin_width, void* found,
                                 void* above, void* below, void* sum_maxes,
                                 void* stream) {
  if (B == 0) return 0;
  if (bin_width <= 0) return kUnsupported;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = grid_of(B * 32);
  if (wide)
    binmax_values_kernel<long long><<<grid, kThreads, 0, st>>>(
        (const long long*)vals, (const long long*)lens, B, L, thr, bin_width,
        (uint8_t*)found, (int32_t*)above, (int32_t*)below,
        (long long*)sum_maxes);
  else
    binmax_values_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        (const int32_t*)vals, (const long long*)lens, B, L, thr, bin_width,
        (uint8_t*)found, (int32_t*)above, (int32_t*)below,
        (long long*)sum_maxes);
  return (int)cudaGetLastError();
}

// Lets the current device's kernels read `peer`'s memory (K13-K16's shards
// on several cards): 0 when granted or already granted, kUnsupported where
// the pair has no peer access, else the CUDA error. Launches nothing.
extern "C" int spn_enable_peer_access(int peer) {
  int dev = 0, ok = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceCanAccessPeer(&ok, dev, peer);
  if (rc != cudaSuccess) return (int)rc;
  if (!ok) return kUnsupported;
  rc = cudaDeviceEnablePeerAccess(peer, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clears the (non-sticky) error it recorded
    return 0;
  }
  return (int)rc;
}
