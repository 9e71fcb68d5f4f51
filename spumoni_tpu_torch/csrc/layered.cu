// K7 `layered_scan` and K8 `layered_classify`: the PML / MS / doc
// recurrence over the layered index (engine v2), one thread per read, on
// NVIDIA Hopper (sm_90a).
//
// Replaces (JAX package, jitted XLA scans on the TPU):
//   K7: spumoni_tpu/engine/scan_engine.py::query_batch_kernel_v2 (the step
//       of engine/layered.py::make_layered_step_fn scanned over the read)
//       and the per-lane flip of _flip_rows: K7 writes forward order, in
//       four modes: PML, PML+doc, MS (the sample pointers), MS+doc.
//   K8: spumoni_tpu/parallel/mesh.py::fused_classify_kernel with the
//       layered step: K7's PML scan with the windowed bin-max folded into
//       the carry (binmax.cuh, shared with K2).
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
// character) makes the descent count the sentinels; the JAX step then reads
// clamped level rows and padded field rows, and so does this one: level
// rows clamp to the level's last row, a field probe clips to the JAX row
// count (probe_bound), and a row past r reads as padding (start n, zeros).
//
// Bound: a step is D + 1 DEPENDENT random reads (one 64-entry level row
// per level, then one field row; the next position comes from the field
// row), so a lane is a pointer chase and the kernel is latency-bound. The
// design answers with lanes in flight: one thread per read keeps (pos,
// length, sample, doc) in registers for the whole read in one launch,
// 128-thread blocks let a whole batch be resident, and charmeta (16 KB as
// int32, 32 KB as int64) sits in shared memory, so a step's first read is
// on chip. A level row is sorted, so "entries <= pos" is an upper-bound
// search: 6 dependent probes inside the row's 256 / 512 bytes instead of
// the TPU's 64-wide compare-count. Steps past a read's length are not run.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launch, or kUnsupported for arguments this
// file does not instantiate.

#include <cuda_runtime.h>

#include <cstdint>

#include "binmax.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupported = -1;
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
  long long rows;         // field rows (r + 1)
  long long probe_bound;  // the JAX package's padded field-row count
  int depth, width;
  long long n, last_run_sample, last_run_edoc, first_run_sdoc;
};

// Entries of a sorted 64-entry row that are <= pos.
template <typename T>
__device__ __forceinline__ int count_le(const T* __restrict__ row,
                                        long long pos) {
  int m = 0;
#pragma unroll
  for (int s = kNode / 2; s > 0; s >>= 1)
    if ((long long)__ldg(row + m + s - 1) <= pos) m += s;
  // the probes reach 63 at most; a full row of entries <= pos is 64
  if (m == kNode - 1 && (long long)__ldg(row + kNode - 1) <= pos) m = kNode;
  return m;
}

// Per-lane recurrence state.
struct Carry {
  long long pos, length, sample, doc;
};

// One backward step of make_layered_step_fn (layered.py:270-390) for byte c.
template <typename T, int MODE>
__device__ __forceinline__ void step(const T (*cm)[kMetaCols],
                                     const T* const* lv,
                                     const long long* lv_rows,
                                     const T* __restrict__ fields,
                                     const Scalars& s, int c, Carry& st) {
  constexpr bool kIsMs = MODE == kMs || MODE == kMsDoc;
  constexpr bool kDoc = MODE == kPmlDoc || MODE == kMsDoc;
  const long long F = cm[c][0], cnt = cm[c][1], lo0 = cm[c][2],
                  hi0 = cm[c][3];
  const long long pos = st.pos;
  // 64-ary descent: rank = index within c of the last run start <= pos;
  // no entry <= pos (dead) is possible only at the top level
  long long rank = 0;
  bool dead = false;
  for (int t = s.depth - 1; t >= 0; --t) {
    long long at = (long long)cm[c][4 + t] + rank;
    at = at < lv_rows[t] - 1 ? at : lv_rows[t] - 1;
    const T* row = lv[t] + at * kNode;
    const int m = count_le(row, pos);
    if (t == s.depth - 1) dead = m == 0;
    rank = rank * kNode + (m > 0 ? m - 1 : 0);
  }
  // row k+1 holds run k and the next run's targets; a dead lane reads row
  // lo0, whose threshold (run lo0's) is 0: the jump down the reference
  // takes when rank(pos, c) == 0 (compute_ms_pml.cpp:259-268)
  long long probe = dead ? lo0 : lo0 + rank + 1;
  probe = probe < 0 ? 0 : probe < s.probe_bound - 1 ? probe
                                                    : s.probe_bound - 1;
  const bool pad = probe >= s.rows;
  const T* f = fields + (pad ? 0 : probe) * s.width;
  const long long start = pad ? s.n : (long long)__ldg(f + kStart);
  const long long len = pad ? 0 : (long long)__ldg(f + kLen);
  const long long cum = pad ? 0 : (long long)__ldg(f + kCum);
  const long long thr = pad ? 0 : (long long)__ldg(f + kThr);
  const bool is_match = !dead && pos < start + len;
  const long long off = pos - start;
  const long long rnk = dead ? 0 : cum + (off < len ? off : len);
  const bool has_next = dead ? cnt > 0 : (rank + 1) < (hi0 - lo0);
  const bool jump_down = !is_match && has_next && pos >= thr;
  const bool empty = cnt == 0;

  st.pos = empty ? F : (is_match || jump_down) ? F + rnk : F + rnk - 1;
  st.length = is_match ? st.length + 1 : 0;
  if (kIsMs)
    st.sample = empty ? 0
                : is_match ? st.sample - 1
                : pad ? 0
                : (long long)__ldg(f + (jump_down ? kSsamp : kEsamp));
  if (kDoc) {
    const long long jumped =
        pad ? 0 : (long long)__ldg(f + (jump_down ? kSdoc : kEdoc));
    if (kIsMs)  // an absent char resets the doc (compute_ms_pml.cpp:639)
      st.doc = empty ? s.first_run_sdoc : is_match ? st.doc : jumped;
    else        // ... and keeps it in PML mode (:303)
      st.doc = (empty || is_match) ? st.doc : jumped;
  }
}

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
  __shared__ T cm[256][kMetaCols];
  __shared__ const T* lv[kMaxDepth];
  __shared__ long long lv_rows[kMaxDepth];
  load_meta(cm, lv, lv_rows, charmeta, levels);
  __syncthreads();
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long len = lens[b];
  len = len < 0 ? 0 : len > L ? L : len;
  const uint8_t* rd = reads + b * L;  // reversed read, left-aligned
  T* ov = vals + b * L + len - 1;     // forward position len-1-t
  T* od = kDoc ? docs + b * L + len - 1 : nullptr;
  Carry st = {s.n - 1, 0, s.last_run_sample, s.last_run_edoc};
  for (long long t = 0; t < len; ++t) {
    step<T, MODE>(cm, lv, lv_rows, fields, s, __ldg(rd + t), st);
    // MS pointers may go negative (the reference's unsigned underflow)
    ov[-t] = (T)(kIsMs ? st.sample : st.length);
    if (kDoc) od[-t] = (T)st.doc;
  }
}

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
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long len64 = lens[b];
  const int len = (int)(len64 < 0 ? 0 : len64 > L ? L : len64);
  const uint8_t* rd = reads + b * L;
  spn::BinMax bins(len, bin_width, thr);
  Carry st = {s.n - 1, 0, s.last_run_sample, s.last_run_edoc};
  for (int t = 0; t < len; ++t) {
    step<T, kPml>(cm, lv, lv_rows, fields, s, __ldg(rd + t), st);
    bins.add(t, st.length);
  }
  bins.finish(found + b, above + b, below + b, sum_maxes + b);
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
  layered_scan_kernel<T, MODE><<<grid_of(a.B), kThreads, 0, a.stream>>>(
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

// Index arguments shared by both entry points; false for a depth or width
// this file does not take.
bool index_args(const void* level_ptrs, int depth, long long rows,
                long long probe_bound, int width, long long n, Levels& levels,
                Scalars& s) {
  if (depth < 1 || depth > kMaxDepth || (width != 4 && width != 8) ||
      rows < 1 || probe_bound < 1)
    return false;
  // host array: the D level pointers, then their row counts
  const long long* p = (const long long*)level_ptrs;
  for (int t = 0; t < kMaxDepth; ++t) {
    levels.p[t] = t < depth ? (const void*)p[t] : nullptr;
    levels.rows[t] = t < depth ? p[depth + t] : 0;
  }
  s.rows = rows;
  s.probe_bound = probe_bound;
  s.depth = depth;
  s.width = width;
  s.n = n;
  return true;
}

}  // namespace

extern "C" int spn_layered_scan(const void* charmeta, const void* level_ptrs,
                                int depth, const void* fields, long long rows,
                                long long probe_bound, int width, int wide,
                                long long n,
                                long long last_run_sample,
                                long long last_run_edoc,
                                long long first_run_sdoc, const void* reads,
                                const void* lens, long long B, long long L,
                                int mode, void* vals, void* docs,
                                void* stream) {
  if (B == 0) return 0;
  ScanArgs a = {};
  if (!index_args(level_ptrs, depth, rows, probe_bound, width, n, a.levels,
                  a.s))
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
                                    const void* fields, long long rows,
                                    long long probe_bound, int width,
                                    int wide, long long n,
                                    const void* reads, const void* lens,
                                    long long B, long long L, long long thr,
                                    int bin_width, void* found, void* above,
                                    void* below, void* sum_maxes,
                                    void* stream) {
  if (B == 0) return 0;
  Levels levels = {};
  Scalars s = {};
  if (!index_args(level_ptrs, depth, rows, probe_bound, width, n, levels, s) ||
      bin_width <= 0)
    return kUnsupported;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    layered_classify_kernel<long long><<<grid_of(B), kThreads, 0, st>>>(
        (const long long*)charmeta, levels, (const long long*)fields, s,
        (const uint8_t*)reads, (const long long*)lens, B, L, thr, bin_width,
        (uint8_t*)found, (int32_t*)above, (int32_t*)below,
        (long long*)sum_maxes);
  else
    layered_classify_kernel<int32_t><<<grid_of(B), kThreads, 0, st>>>(
        (const int32_t*)charmeta, levels, (const int32_t*)fields, s,
        (const uint8_t*)reads, (const long long*)lens, B, L, thr, bin_width,
        (uint8_t*)found, (int32_t*)above, (int32_t*)below,
        (long long*)sum_maxes);
  return (int)cudaGetLastError();
}
