// K3 `ms_scan`, K4 `ms_extend` and K5 `binmax_values`: matching statistics
// and document tracking over the block-bits rows, on NVIDIA Hopper (sm_90a).
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
//
// Bounds and design:
//   K3 is K1's dependent pointer chase (one random row read per step, the
//   next position comes from it) plus one msrow read of the same block and
//   two independent table reads (jump_t / jump_d at the jump id). One
//   thread per read carries (pos, jump id, d or length) in registers; the
//   run-rank words are read before the probe so both row reads are in
//   flight together. Latency-bound, like K1.
//   K4 is one thread per read walking at most 3 L (read byte, text byte)
//   compares; each text read is a random access into the ~92 MB text.
//   K5 is one warp per read: coalesced reads of the value row, a warp max
//   per bin. Bandwidth-bound on the [B, L] matrix.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launch, or kUnsupported for arguments this
// file does not instantiate.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "blockbits_pml.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupported = -1;

enum Mode { kMs = 0, kMsDoc = 1, kPmlDoc = 2 };

// Char-local run rank at pos for code rk: the msrow checkpoint plus the
// run-start bits at offsets < off (blockbits.py:874-892).
template <int P, int PACK>
__device__ __forceinline__ int run_rank(const uint32_t* __restrict__ msrows,
                                        const spn::IndexScalars& s,
                                        long long pos, int rk) {
  constexpr int NSLOTS = PACK == 2 ? 4 : 8;
  constexpr int WPC = P / 32;
  constexpr int WM = NSLOTS * (1 + WPC);
  const uint32_t* mrow = msrows + spn::block_of<P>(s, pos) * WM;
  const int off = (int)(pos & (P - 1));
  const uint32_t* bits = mrow + NSLOTS + rk * WPC;
  const int wcut = off >> 5;
  int k = (int)__ldg(mrow + rk);
  for (int w = 0; w < wcut; ++w) k += __popc(__ldg(bits + w));
  return k + __popc(__ldg(bits + wcut) & ((1u << (off & 31)) - 1u));
}

template <int P, int PACK, bool WIDE, int MODE>
__global__ void __launch_bounds__(kThreads)
ms_scan_kernel(const uint32_t* __restrict__ rows,
               const uint32_t* __restrict__ msrows,
               const long long* __restrict__ tab_g, int sq,
               const uint8_t* __restrict__ reads,
               const long long* __restrict__ lens, long long B, long long L,
               const typename std::conditional<WIDE, long long,
                                               int32_t>::type* jump_t,
               const int32_t* __restrict__ jump_d,
               typename std::conditional<WIDE, long long, int32_t>::type* vals,
               typename std::conditional<WIDE, long long, int32_t>::type* docs,
               spn::IndexScalars s) {
  using PosT = typename std::conditional<WIDE, long long, int32_t>::type;
  constexpr int NSLOTS = PACK == 2 ? 4 : 8;
  __shared__ spn::CharTab tab;
  spn::load_char_tab(tab, tab_g, sq);
  __syncthreads();
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long len = lens[b];
  len = len < 0 ? 0 : len > L ? L : len;
  const uint8_t* rd = reads + b * L;  // reversed read, left-aligned
  PosT* ov = vals + b * L + len - 1;  // forward position len-1-t
  PosT* od = MODE == kPmlDoc || MODE == kMsDoc ? docs + b * L + len - 1
                                               : nullptr;
  const int empty_id = (int)(2 * s.r);  // EMPTY; INIT is 2r+1
  long long pos = s.n - 1;
  int jidx = empty_id + 1;
  int run = 0;  // MS: matches since the last jump (d); PML: the length
  for (long long t = 0; t < len; ++t) {
    const int qc = __ldg(rd + t);
    const int code = tab.code[qc];
    const int rk = code < NSLOTS - 1 ? code : NSLOTS - 1;
    // the msrow read first: independent of the row read, both in flight
    const int k_local = run_rank<P, PACK>(msrows, s, pos, rk);
    const spn::Probe pr = spn::probe<P, PACK, WIDE>(rows, tab, s, pos, qc);
    int jdown = 2 * (tab.run_base[qc] + k_local);
    if (pr.is_tq) jdown = (int)(2 * s.term_runidx);
    // a jump up targets the previous run's END entry (jdown - 1)
    int jjump = pr.jump_up ? jdown - 1 : jdown;
    jjump = jjump < 0 ? 0 : jjump;
    if (MODE == kPmlDoc) {
      // an absent character KEEPS the doc (compute_ms_pml.cpp:303)
      if (!pr.is_match && !pr.empty) jidx = jjump;
      run = pr.is_match ? run + 1 : 0;
      ov[-t] = (PosT)run;
    } else {
      // an absent character resets to EMPTY (:639-643)
      if (!pr.is_match) jidx = pr.empty ? empty_id : jjump;
      run = pr.is_match ? run + 1 : 0;
      // may go negative: the reference's unsigned underflow, kept signed
      ov[-t] = (PosT)(jump_t[jidx] - (PosT)run);
    }
    if (MODE != kMs) od[-t] = (PosT)jump_d[jidx];
    pos = pr.new_pos;
  }
}

template <typename PosT>
__global__ void __launch_bounds__(kThreads)
ms_extend_kernel(const uint8_t* __restrict__ text, long long ntext,
                 long long nt, const uint8_t* __restrict__ reads,
                 const long long* __restrict__ lens,
                 const PosT* __restrict__ ptrs, long long B, long long L,
                 PosT* __restrict__ out) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long len = lens[b];
  len = len < 0 ? 0 : len > L ? L : len;
  const uint8_t* rd = reads + b * L;
  const PosT* pp = ptrs + b * L;
  PosT* o = out + b * L;
  // two pointers: extend the match at i by one character, or emit its
  // length and move to i+1 keeping max(l-1, 0) (MS are 1-Lipschitz)
  long long i = 0, l = 0;
  while (i < len) {
    const long long ptr = (long long)pp[i];
    const long long tpos = ptr + l;
    bool ok = false;
    // nt is the JAX package's zero-padded text length: past the text, a
    // read byte is compared with 0
    if (i + l < len && ptr >= 0 && tpos >= 0 && tpos < nt) {
      const uint8_t tch = tpos < ntext ? __ldg(text + tpos) : (uint8_t)0;
      ok = __ldg(rd + i + l) == tch;
    }
    if (ok) {
      ++l;
    } else {
      o[i] = (PosT)l;
      ++i;
      l = l > 0 ? l - 1 : 0;
    }
  }
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
  long long B, L;
  int P, pack, mode;
  bool wide;
  const void* jump_t;
  const int32_t* jump_d;
  void* vals;
  void* docs;
  spn::IndexScalars s;
  cudaStream_t stream;
};

unsigned grid_of(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <int P, int PACK, bool WIDE, int MODE>
void launch_scan(const ScanArgs& a) {
  using PosT = typename std::conditional<WIDE, long long, int32_t>::type;
  ms_scan_kernel<P, PACK, WIDE, MODE>
      <<<grid_of(a.B), kThreads, 0, a.stream>>>(
          a.rows, a.msrows, a.tab, a.sq, a.reads, a.lens, a.B, a.L,
          (const PosT*)a.jump_t, a.jump_d, (PosT*)a.vals, (PosT*)a.docs,
          a.s);
}

template <int P, int PACK, bool WIDE>
bool launch_modes(const ScanArgs& a) {
  switch (a.mode) {
    case kMs: launch_scan<P, PACK, WIDE, kMs>(a); return true;
    case kMsDoc: launch_scan<P, PACK, WIDE, kMsDoc>(a); return true;
    case kPmlDoc: launch_scan<P, PACK, WIDE, kPmlDoc>(a); return true;
    default: return false;
  }
}

#define SPN_CASE(P_, PACK_, WIDE_)                                     \
  if (a.P == P_ && a.pack == PACK_ && a.wide == WIDE_)                 \
    return launch_modes<P_, PACK_, WIDE_>(a);
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

extern "C" int spn_ms_scan(const void* rows, const void* msrows, long long nb,
                           int P, int pack, int wide, long long n,
                           long long term_pos, long long F_term,
                           int term_code, long long r, long long term_runidx,
                           const void* tab, int sq, const void* reads,
                           const void* lens, long long B, long long L,
                           const void* jump_t, const void* jump_d, int mode,
                           void* vals, void* docs, void* stream) {
  if (B == 0) return 0;
  ScanArgs a = {};
  a.rows = (const uint32_t*)rows;
  a.msrows = (const uint32_t*)msrows;
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
  a.jump_t = jump_t;
  a.jump_d = (const int32_t*)jump_d;
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
  return dispatch_scan(a) ? (int)cudaGetLastError() : kUnsupported;
}

extern "C" int spn_ms_extend(const void* text, long long ntext, long long nt,
                             const void* reads, const void* lens,
                             const void* ptrs, long long B, long long L,
                             int wide, void* out, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    ms_extend_kernel<long long><<<grid_of(B), kThreads, 0, st>>>(
        (const uint8_t*)text, ntext, nt, (const uint8_t*)reads,
        (const long long*)lens, (const long long*)ptrs, B, L,
        (long long*)out);
  else
    ms_extend_kernel<int32_t><<<grid_of(B), kThreads, 0, st>>>(
        (const uint8_t*)text, ntext, nt, (const uint8_t*)reads,
        (const long long*)lens, (const int32_t*)ptrs, B, L, (int32_t*)out);
  return (int)cudaGetLastError();
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
