// K7 `layered_scan`, K8 `layered_classify` and K14 `layered_classify_tp`:
// the PML / MS / doc recurrence over the layered index (engine v2) on
// NVIDIA Hopper (sm_90a), every kernel a lane group per read on one step
// (spn::layered::group_step, layered_step.cuh): K7 with kGroup = 8 threads
// per read, K8 and K14 with kClassifyGroup = 4.
//
// Replaces (JAX package, jitted XLA scans on the TPU):
//   K7: spumoni_tpu/engine/scan_engine.py::query_batch_kernel_v2 (the step
//       of engine/layered.py::make_layered_step_fn scanned over the read)
//       and the per-lane flip of _flip_rows: K7 writes forward order, in
//       four modes: PML, PML+doc, MS (the sample pointers), MS+doc.
//   K8: spumoni_tpu/parallel/mesh.py::fused_classify_kernel with the
//       layered step: K7's PML scan with the windowed bin-max folded into
//       the carry (binmax.cuh, shared with K2).
//   K14: spumoni_tpu/parallel/tp.py::TpPmlClassifier._classify_fn with the
//       layered step: K8's body with `fields` in S shards (sharded.cuh).
//
// Layout (spumoni_tpu_torch/engine/layered.py; T = int32 or int64):
//   charmeta [256, 16] T   F, cnt, lo0, hi0, then the row offset of the
//                          char's first row in each level
//   level t  [rows_t, 64]  every 64^t-th run start of each char, ascending,
//                          padded with the sentinel n
//   fields   [r+1, W]      row k+1 = start, len, cum of run k, thr of run
//                          k+1 (W = 4), then esamp_k, ssamp_{k+1}, edoc_k,
//                          sdoc_{k+1} (W = 8)
//
// A position past the BWT (n, after a byte that sorts after every index
// character) makes the descent count the sentinels; level rows clamp to
// the level's last row, and the field probe stops at c's last run, as
// SPUMONI's query loop does (the JAX step reads padded field rows there):
// a probe never passes row hi0 <= r.
//
// Bound: a step is a chain of dependent random reads (the level rows of
// the descent, one 64-entry row a level, each row's choice from the last
// count; then one field row, from which the next position comes), so a
// read is a pointer chase and each kernel is latency-bound. At the lanes
// the runs launch (8,192 a value-run group, 32,768 a report-only batch)
// the card is mostly empty, so the time is the chain's length in round
// trips. charmeta (16 KB as int32, 32 KB as int64) sits in shared memory;
// steps past a read's length are not run.
//   K7 (layered_step.cuh) runs one round trip a level: its 8 lanes read a
//   level row as 16-byte loads and sum their counts of entries <= pos by
//   shuffle (the TPU's 64-wide compare-count), the top level's row is
//   loaded a step ahead (it depends on the character only), and the field
//   slots the mode reads are loaded at once and the sample or doc slot
//   chosen after they land: D round trips a step (D - 1 levels, the field
//   row). The group stores 8 consecutive outputs at once.
//   K8 and K14 are K7's PML scan on the same group step with the bin-max
//   carry in every lane (binmax.cuh): D round trips a step, no stores but
//   the verdict, which lane 0 writes. They share one body,
//   classify_reads, whose field-row source is the only difference: K14
//   reads each row from its shard through spn::shard_at (FlatFields,
//   ShardFields in layered_step.cuh), as K13 and K15 read theirs. Their
//   runs launch them at 32,768 lanes (a report-only batch), where 4
//   threads a read beat 8 (PERF.md section 6): for K8 32,768 groups of 8
//   (56 registers) run in 1.7 waves, of 4 (64 registers) in one; 8 are
//   faster only at 8,192 lanes, where no run launches them.
//   K1, K3 / K15 and K9 take a lane group of 8 on their own steps
//   (ms_step.cuh, occ_step.cuh), K2 / K13 and K10 one of 4 on K1's and
//   K9's.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launch, or kUnsupported for arguments this
// file does not instantiate.

#include <cuda_runtime.h>

#include <cstdint>

#include "binmax.cuh"
#include "layered_step.cuh"
#include "sharded.cuh"

namespace {

// the layout, Mode, Field, Levels, Scalars and Carry
using namespace spn::layered;

constexpr int kThreads = 128;
constexpr int kUnsupported = -1;
constexpr int kGroup = 8;          // threads per read of K7
constexpr int kClassifyGroup = 4;  // threads per read of K8 and K14

// charmeta and the level pointers and row counts into shared memory (all
// threads of the block take part; the caller synchronises).
template <typename T>
__device__ __forceinline__ void load_meta(T (*cm)[kMetaCols], const T** lv,
                                          long long* lv_rows,
                                          const T* __restrict__ charmeta,
                                          const Levels& levels) {
  for (int i = threadIdx.x; i < 256 * kMetaCols; i += blockDim.x)
    cm[i / kMetaCols][i % kMetaCols] = charmeta[i];
  if (threadIdx.x < kMaxDepth) {
    lv[threadIdx.x] = (const T*)levels.p[threadIdx.x];
    lv_rows[threadIdx.x] = levels.rows[threadIdx.x];
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
layered_scan_kernel(const T* __restrict__ charmeta, Levels levels,
                    const T* __restrict__ fields, Scalars s,
                    const uint8_t* __restrict__ reads,
                    const long long* __restrict__ lens, long long B,
                    long long L, T* __restrict__ vals, T* __restrict__ docs) {
  constexpr bool kIsMs = MODE == kMs || MODE == kMsDoc;
  constexpr bool kDoc = MODE == kPmlDoc || MODE == kMsDoc;
  constexpr int G = kGroup;
  using Lay = GroupLayout<T, MODE, G>;
  __shared__ T cm[256][kMetaCols];
  __shared__ const T* lv[kMaxDepth];
  __shared__ long long lv_rows[kMaxDepth];
  load_meta(cm, lv, lv_rows, charmeta, levels);
  __syncthreads();
  const long long b =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= B) return;  // the whole group leaves together
  const int lane = (int)(threadIdx.x & (G - 1));
  long long len = lens[b];
  len = len < 0 ? 0 : len > L ? L : len;
  const uint8_t* rd = reads + b * L;  // reversed read, left-aligned
  // forward position len-1-t: column -t of ov / od
  spn::GroupSlots<T, G> ov = {vals + b * L + len - 1, 0};
  spn::GroupSlots<T, G> od = {kDoc ? docs + b * L + len - 1 : nullptr, 0};
  Carry st = {s.n - 1, 0, s.last_run_sample, s.last_run_edoc};
  // this step's character and top-level row share, and the next step's
  // character: the next top row is loaded a step ahead
  int c = len > 0 ? __ldg(rd) : 0;
  int cn = len > 1 ? __ldg(rd + 1) : 0;
  uint4 top[Lay::kRow], nxt[Lay::kRow];
  if (len > 0)
    load_level<T, MODE, G>(top_row(cm, lv, lv_rows, s.depth, c), lane, top);
  for (long long t = 0; t < len; ++t) {
    if (t + 1 < len)
      load_level<T, MODE, G>(top_row(cm, lv, lv_rows, s.depth, cn), lane,
                             nxt);
    const int c2 = t + 2 < len ? __ldg(rd + t + 2) : 0;
    group_step<T, MODE, G>(cm, lv, lv_rows, FlatFields<T>{fields}, s, c,
                           top, lane, st);
    // MS pointers may go negative (the reference's unsigned underflow)
    ov.put(t, (T)(kIsMs ? st.sample : st.length), lane);
    if (kDoc) od.put(t, (T)st.doc, lane);
#pragma unroll
    for (int i = 0; i < Lay::kRow; ++i) top[i] = nxt[i];
    c = cn;
    cn = c2;
  }
  ov.flush(len, lane);
  if (kDoc) od.flush(len, lane);
}

// K8 / K14: K7's PML scan with the bin-max carry: a group of
// kClassifyGroup threads per read steps it through group_step, every lane
// carrying the same Carry and BinMax; lane 0 writes the verdict. The field
// rows come from `fields` (FlatFields: K8, ShardFields: K14).
template <typename T, typename Fields>
__device__ __forceinline__ void classify_reads(
    const T (*cm)[kMetaCols], const T* const* lv, const long long* lv_rows,
    const Fields& fields, const Scalars& s, const uint8_t* reads,
    const long long* lens, long long B, long long L, long long thr,
    int bin_width, uint8_t* found, int32_t* above, int32_t* below,
    long long* sum_maxes) {
  constexpr int G = kClassifyGroup;
  using Lay = GroupLayout<T, kPml, G>;
  const long long b =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= B) return;  // the whole group leaves together
  const int lane = (int)(threadIdx.x & (G - 1));
  const long long len64 = lens[b];
  const int len = (int)(len64 < 0 ? 0 : len64 > L ? L : len64);
  const uint8_t* rd = reads + b * L;  // reversed read, left-aligned
  spn::BinMax bins(len, bin_width, thr);
  Carry st = {s.n - 1, 0, s.last_run_sample, s.last_run_edoc};
  // this step's character and top-level row share, and the next step's
  // character: the next top row is loaded a step ahead
  int c = len > 0 ? __ldg(rd) : 0;
  int cn = len > 1 ? __ldg(rd + 1) : 0;
  uint4 top[Lay::kRow], nxt[Lay::kRow];
  if (len > 0)
    load_level<T, kPml, G>(top_row(cm, lv, lv_rows, s.depth, c), lane, top);
  for (int t = 0; t < len; ++t) {
    if (t + 1 < len)
      load_level<T, kPml, G>(top_row(cm, lv, lv_rows, s.depth, cn), lane,
                             nxt);
    const int c2 = t + 2 < len ? __ldg(rd + t + 2) : 0;
    group_step<T, kPml, G>(cm, lv, lv_rows, fields, s, c, top, lane, st);
    bins.add(t, st.length);
#pragma unroll
    for (int i = 0; i < Lay::kRow; ++i) top[i] = nxt[i];
    c = cn;
    cn = c2;
  }
  if (lane == 0) bins.finish(found + b, above + b, below + b, sum_maxes + b);
}

// K8: the body over one field table.
template <typename T>
__global__ void __launch_bounds__(kThreads)
layered_classify_kernel(const T* __restrict__ charmeta, Levels levels,
                        const T* __restrict__ fields, Scalars s,
                        const uint8_t* __restrict__ reads,
                        const long long* __restrict__ lens, long long B,
                        long long L, long long thr, int bin_width,
                        uint8_t* __restrict__ found,
                        int32_t* __restrict__ above,
                        int32_t* __restrict__ below,
                        long long* __restrict__ sum_maxes) {
  __shared__ T cm[256][kMetaCols];
  __shared__ const T* lv[kMaxDepth];
  __shared__ long long lv_rows[kMaxDepth];
  load_meta(cm, lv, lv_rows, charmeta, levels);
  __syncthreads();
  classify_reads<T>(cm, lv, lv_rows, FlatFields<T>{fields}, s, reads, lens,
                    B, L, thr, bin_width, found, above, below, sum_maxes);
}

// K14: the body over the fields in shards.
template <typename T>
__global__ void __launch_bounds__(kThreads)
layered_classify_tp_kernel(const T* __restrict__ charmeta, Levels levels,
                           const spn::ShardedRows<T> fields, Scalars s,
                           const uint8_t* __restrict__ reads,
                           const long long* __restrict__ lens, long long B,
                           long long L, long long thr, int bin_width,
                           uint8_t* __restrict__ found,
                           int32_t* __restrict__ above,
                           int32_t* __restrict__ below,
                           long long* __restrict__ sum_maxes) {
  __shared__ T cm[256][kMetaCols];
  __shared__ const T* lv[kMaxDepth];
  __shared__ long long lv_rows[kMaxDepth];
  load_meta(cm, lv, lv_rows, charmeta, levels);
  __syncthreads();
  classify_reads<T>(cm, lv, lv_rows, ShardFields<T>{fields}, s, reads, lens,
                    B, L, thr, bin_width, found, above, below, sum_maxes);
}

unsigned grid_of(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

struct ScanArgs {
  const void* charmeta;
  Levels levels;
  const void* fields;
  Scalars s;
  const uint8_t* reads;
  const long long* lens;
  long long B, L;
  void* vals;
  void* docs;
  cudaStream_t stream;
};

template <typename T, int MODE>
void launch_scan(const ScanArgs& a) {
  layered_scan_kernel<T, MODE><<<grid_of(a.B * kGroup), kThreads, 0,
                                 a.stream>>>(
      (const T*)a.charmeta, a.levels, (const T*)a.fields, a.s, a.reads,
      a.lens, a.B, a.L, (T*)a.vals, (T*)a.docs);
}

template <typename T>
bool launch_modes(const ScanArgs& a, int mode) {
  switch (mode) {
    case kPml: launch_scan<T, kPml>(a); return true;
    case kPmlDoc: launch_scan<T, kPmlDoc>(a); return true;
    case kMs: launch_scan<T, kMs>(a); return true;
    case kMsDoc: launch_scan<T, kMsDoc>(a); return true;
    default: return false;
  }
}

// Index arguments shared by the entry points; false for a depth or width
// this file does not take.
bool index_args(const void* level_ptrs, int depth, int width, long long n,
                Levels& levels, Scalars& s) {
  if (depth < 1 || depth > kMaxDepth || (width != 4 && width != 8))
    return false;
  // host array: the D level pointers, then their row counts
  const long long* p = (const long long*)level_ptrs;
  for (int t = 0; t < kMaxDepth; ++t) {
    levels.p[t] = t < depth ? (const void*)p[t] : nullptr;
    levels.rows[t] = t < depth ? p[depth + t] : 0;
  }
  s.depth = depth;
  s.width = width;
  s.n = n;
  return true;
}

}  // namespace

extern "C" int spn_layered_scan(const void* charmeta, const void* level_ptrs,
                                int depth, const void* fields, int width,
                                int wide, long long n,
                                long long last_run_sample,
                                long long last_run_edoc,
                                long long first_run_sdoc, const void* reads,
                                const void* lens, long long B, long long L,
                                int mode, void* vals, void* docs,
                                void* stream) {
  if (B == 0) return 0;
  ScanArgs a = {};
  if (!index_args(level_ptrs, depth, width, n, a.levels, a.s))
    return kUnsupported;
  // the MS modes read the sample slots, the doc modes the doc slots
  if (mode != kPml && width != 8) return kUnsupported;
  a.charmeta = charmeta;
  a.fields = fields;
  a.s.last_run_sample = last_run_sample;
  a.s.last_run_edoc = last_run_edoc;
  a.s.first_run_sdoc = first_run_sdoc;
  a.reads = (const uint8_t*)reads;
  a.lens = (const long long*)lens;
  a.B = B;
  a.L = L;
  a.vals = vals;
  a.docs = docs;
  a.stream = (cudaStream_t)stream;
  const bool ok = wide ? launch_modes<long long>(a, mode)
                       : launch_modes<int32_t>(a, mode);
  return ok ? (int)cudaGetLastError() : kUnsupported;
}

extern "C" int spn_layered_classify(const void* charmeta,
                                    const void* level_ptrs, int depth,
                                    const void* fields, int width,
                                    int wide, long long n,
                                    const void* reads, const void* lens,
                                    long long B, long long L, long long thr,
                                    int bin_width, void* found, void* above,
                                    void* below, void* sum_maxes,
                                    void* stream) {
  if (B == 0) return 0;
  Levels levels = {};
  Scalars s = {};
  if (!index_args(level_ptrs, depth, width, n, levels, s) || bin_width <= 0)
    return kUnsupported;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = grid_of(B * kClassifyGroup);
  if (wide)
    layered_classify_kernel<long long><<<grid, kThreads, 0, st>>>(
        (const long long*)charmeta, levels, (const long long*)fields, s,
        (const uint8_t*)reads, (const long long*)lens, B, L, thr, bin_width,
        (uint8_t*)found, (int32_t*)above, (int32_t*)below,
        (long long*)sum_maxes);
  else
    layered_classify_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        (const int32_t*)charmeta, levels, (const int32_t*)fields, s,
        (const uint8_t*)reads, (const long long*)lens, B, L, thr, bin_width,
        (uint8_t*)found, (int32_t*)above, (int32_t*)below,
        (long long*)sum_maxes);
  return (int)cudaGetLastError();
}

// K14: fields is a host array of S shard pointers, rows_per_shard rows
// each.
extern "C" int spn_layered_classify_tp(const void* charmeta,
                                       const void* level_ptrs, int depth,
                                       const void* fields, int S,
                                       long long rows_per_shard,
                                       int width, int wide, long long n,
                                       const void* reads, const void* lens,
                                       long long B, long long L,
                                       long long thr, int bin_width,
                                       void* found, void* above, void* below,
                                       void* sum_maxes, void* stream) {
  if (B == 0) return 0;
  Levels levels = {};
  Scalars s = {};
  if (!index_args(level_ptrs, depth, width, n, levels, s) || bin_width <= 0)
    return kUnsupported;
  spn::ShardedRows<char> shards;
  if (!spn::sharded_rows(shards, fields, S, rows_per_shard))
    return kUnsupported;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = grid_of(B * kClassifyGroup);
  if (wide)
    layered_classify_tp_kernel<long long><<<grid, kThreads, 0, st>>>(
        (const long long*)charmeta, levels, spn::retype<long long>(shards), s,
        (const uint8_t*)reads, (const long long*)lens, B, L, thr, bin_width,
        (uint8_t*)found, (int32_t*)above, (int32_t*)below,
        (long long*)sum_maxes);
  else
    layered_classify_tp_kernel<int32_t><<<grid, kThreads, 0, st>>>(
        (const int32_t*)charmeta, levels, spn::retype<int32_t>(shards), s,
        (const uint8_t*)reads, (const long long*)lens, B, L, thr, bin_width,
        (uint8_t*)found, (int32_t*)above, (int32_t*)below,
        (long long*)sum_maxes);
  return (int)cudaGetLastError();
}
