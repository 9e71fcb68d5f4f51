// K1 `pml_scan` and K2 `pml_classify`: the PML recurrence over the
// block-bits rows, one thread per read, on NVIDIA Hopper (sm_90a).
//
// Replaces (JAX package, jitted XLA scans on the TPU):
//   K1: spumoni_tpu/engine/scan_engine.py::query_batch_kernel_v4 (the v4
//       step of engine/blockbits.py scanned over the read), plus the
//       per-lane output flip of _flip_rows: K1 writes forward order.
//   K2: spumoni_tpu/parallel/mesh.py::fused_classify_kernel (the same scan
//       with the windowed bin-max folded into the carry).
//
// Bound: each step is one DEPENDENT random read of one index row (208 B at
// P=256, 400 B at P=512 for pack=2) — the next position comes from this
// row — so a lane is a pointer chase and the kernel is latency-bound. The
// design answers with lanes in flight: one thread per read keeps (pos,
// length) in registers through all of its steps in one launch, 128-thread
// blocks let the whole batch (65,536 reads) be resident at once, and a step
// touches only the row words it needs (checkpoint slot, char words up to
// the offset, one up-bit word). The per-character table sits in shared
// memory. Steps past a read's length are not run: their outputs are never
// read (mesh.py:102-111, scan_engine.py:1966).
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launch, or kUnsupported for a layout this
// file does not instantiate.

#include <cuda_runtime.h>

#include <cstdint>

#include "binmax.cuh"
#include "blockbits_pml.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupported = -1;

template <int P, int PACK, bool WIDE>
__global__ void __launch_bounds__(kThreads)
pml_scan_kernel(const uint32_t* __restrict__ rows,
                const long long* __restrict__ tab_g, int sq,
                const uint8_t* __restrict__ reads,
                const long long* __restrict__ lens, long long B, long long L,
                int32_t* __restrict__ out, spn::IndexScalars s) {
  __shared__ spn::CharTab tab;
  spn::load_char_tab(tab, tab_g, sq);
  __syncthreads();
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long len = lens[b];
  len = len < 0 ? 0 : len > L ? L : len;
  const uint8_t* rd = reads + b * L;   // reversed read, left-aligned
  int32_t* o = out + b * L + len - 1;  // forward position len-1-t
  long long pos = s.n - 1;
  int32_t length = 0;
  for (long long t = 0; t < len; ++t) {
    bool match;
    pos = spn::pml_step<P, PACK, WIDE>(rows, tab, s, pos, __ldg(rd + t),
                                       match);
    length = match ? length + 1 : 0;
    o[-t] = length;
  }
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
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long len64 = lens[b];
  const int len = (int)(len64 < 0 ? 0 : len64 > L ? L : len64);
  const uint8_t* rd = reads + b * L;
  spn::BinMax bins(len, bin_width, thr);
  long long pos = s.n - 1;
  int length = 0;
  for (int t = 0; t < len; ++t) {
    bool match;
    pos = spn::pml_step<P, PACK, WIDE>(rows, tab, s, pos, __ldg(rd + t),
                                       match);
    length = match ? length + 1 : 0;
    bins.add(t, length);
  }
  bins.finish(found + b, above + b, below + b, sum_maxes + b);
}

struct Args {
  const uint32_t* rows;
  const long long* tab;
  int sq;
  const uint8_t* reads;
  const long long* lens;
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

unsigned grid_of(const Args& a) {
  return (unsigned)((a.B + kThreads - 1) / kThreads);
}

template <int P, int PACK, bool WIDE>
void launch_scan(const Args& a) {
  pml_scan_kernel<P, PACK, WIDE><<<grid_of(a), kThreads, 0, a.stream>>>(
      a.rows, a.tab, a.sq, a.reads, a.lens, a.B, a.L, a.out, a.s);
}

template <int P, int PACK, bool WIDE>
void launch_classify(const Args& a) {
  pml_classify_kernel<P, PACK, WIDE><<<grid_of(a), kThreads, 0, a.stream>>>(
      a.rows, a.tab, a.sq, a.reads, a.lens, a.B, a.L, a.thr, a.bin_width,
      a.found, a.above, a.below, a.sum_maxes, a.s);
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

extern "C" int spn_pml_scan(const void* rows, long long nb, int P, int pack,
                            int wide, long long n, long long term_pos,
                            long long F_term, int term_code, const void* tab,
                            int sq, const void* reads, const void* lens,
                            long long B, long long L, void* out,
                            void* stream) {
  if (B == 0) return 0;
  Args a = common(rows, nb, P, pack, wide, n, term_pos, F_term, term_code,
                  tab, sq, reads, lens, B, L, stream);
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
