// K9 `occ_scan` and K10 `occ_classify`: the PML / MS / doc recurrence over
// the occ-block index (engine v3) on NVIDIA Hopper (sm_90a), both a lane
// group per read on one step (spn::occ::group_step, occ_step.cuh): K9 with
// kGroup = 8 threads per read, K10 with kClassifyGroup = 4.
//
// Replaces (JAX package, jitted XLA scans on the TPU):
//   K9:  spumoni_tpu/engine/scan_engine.py::query_batch_kernel_v3 (the step
//        of engine/occblock.py::make_occ_step_fn scanned over the read from
//        occ_initial_state, its sentinel step and realignment) and the
//        per-lane flip of _flip_rows: K9 writes forward order, in four
//        modes: PML, PML+doc, MS (the sample pointers), MS+doc.
//   K10: spumoni_tpu/parallel/mesh.py::fused_classify_kernel with the occ
//        step: K9's PML scan with the windowed bin-max folded into the carry
//        (binmax.cuh, shared with K2, K8, K13 and K14).
//
// Layout (spumoni_tpu_torch/engine/occblock.py; one int32 row per P BWT
// positions, P a power of two):
//   [0, 16)        cp[rank] = F[char] + occ(char, block_start)
//   [16, T0)       4-bit build ranks, nibble 0 = prevchar (the previous
//                  block's last character), 15 = padding
//   [T0, T0 + P)   thr by F-space offset
//   [S0, S0 + 2P)  samples_start, then samples_last shifted by one (MS)
//   [D0, D0 + 2P)  sdoc, then edoc shifted by one (doc tracking)
//
// The jump decision is deferred one step: a step carries the unresolved
// candidate cand and resolves it (jump up: cand - 1) from the threshold at
// cand's offset in cand's own row, the row it reads for its own character.
// So MS samples and doc ids of read position i resolve at step i + 1; K9
// writes them there, and after a read's last character runs one more
// resolution that reads no character (the JAX sentinel iteration). PML
// lengths resolve in-step. A jump up from cand % P == 0 lands in the
// previous block: pos_off = -1, whose character is nibble 0.
//
// Bound: a step reads one row, chosen by the candidate the last step
// computed, so a read is a pointer chase and each kernel is latency-bound.
// At the lanes the runs launch (8,192 a value-run group, 32,768 a
// report-only batch) the card is mostly empty, so the time is the number
// of dependent round trips a step. The carry stays in registers for the
// whole read in one launch (long reads included) and the per-character
// table sits in shared memory.
//   K9 (occ_step.cuh) issues every load of a step at once over its 8 lanes
//   (the threshold, both sample and both doc candidates, the checkpoint,
//   the char words up to the offset as 4-byte loads: the row stride is odd)
//   and sums the masked counts by shuffle: one round trip a step at P =
//   128. The group stores 8 consecutive outputs at once.
//   K10 is K9's PML loop on the same step (no lagging resolution: PML
//   lengths resolve in-step) with the bin-max carry in every lane; lane 0
//   writes the verdict. Its runs launch it at 32,768 lanes (a report-only
//   batch), where 4 lanes a read beat 8 (PERF.md section 6); at G = 4 each
//   lane loads 5 char words a round (words_per_lane), so P = 128 stays one
//   round trip a step.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launch, or kUnsupported for arguments this
// file does not take.

#include <cuda_runtime.h>

#include <cstdint>

#include "binmax.cuh"
#include "blockbits_pml.cuh"  // spn::CharTab, spn::load_char_tab
#include "occ_step.cuh"

namespace {

// the row layout, Mode, Scalars, Carry, seed, row_of and group_step
using namespace spn::occ;

constexpr int kThreads = 128;
constexpr int kUnsupported = -1;
constexpr int kGroup = 8;          // threads per read of K9
constexpr int kClassifyGroup = 4;  // threads per read of K10

template <int MODE>
__global__ void __launch_bounds__(kThreads)
occ_scan_kernel(const uint32_t* __restrict__ blocks,
                const long long* __restrict__ tab_g, int sq,
                const uint8_t* __restrict__ reads,
                const long long* __restrict__ lens, long long B, long long L,
                Scalars s, int32_t* __restrict__ vals,
                int32_t* __restrict__ docs) {
  constexpr bool kIsMs = MODE == kMs || MODE == kMsDoc;
  constexpr bool kDoc = MODE == kPmlDoc || MODE == kMsDoc;
  constexpr int G = kGroup;
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
  // forward position len-1-j: column -j of ov / od
  spn::GroupSlots<int32_t, G> ov = {vals + b * L + len - 1, 0};
  spn::GroupSlots<int32_t, G> od = {kDoc ? docs + b * L + len - 1 : nullptr,
                                    0};
  Carry st = seed(s);
  // lagging modes run one resolution past the last character
  const long long steps = len + ((kIsMs || kDoc) ? 1 : 0);
  int qn = len > 0 ? __ldg(rd) : 0;  // the next step's code
  for (long long t = 0; t < steps; ++t) {
    const int qc = t < len ? qn : -1;
    if (t + 1 < len) qn = __ldg(rd + t + 1);
    int sample, doc;
    group_step<MODE, G>(row_of(blocks, s, st.cand), s, tab, qc, lane, st,
                        sample, doc);
    if (t > 0) {  // read position t - 1's resolved sample and doc id
      if (kIsMs) ov.put(t - 1, sample, lane);
      if (kDoc) od.put(t - 1, doc, lane);
    }
    if (!kIsMs && t < len) ov.put(t, st.length, lane);
  }
  ov.flush(len, lane);
  if (kDoc) od.flush(len, lane);
}

// K10: K9's PML loop with the bin-max carry: a group of kClassifyGroup
// threads per read steps it through group_step, every lane carrying the
// same Carry and BinMax; lane 0 writes the verdict.
__global__ void __launch_bounds__(kThreads)
occ_classify_kernel(const uint32_t* __restrict__ blocks,
                    const long long* __restrict__ tab_g, int sq,
                    const uint8_t* __restrict__ reads,
                    const long long* __restrict__ lens, long long B,
                    long long L, Scalars s, long long thr, int bin_width,
                    uint8_t* __restrict__ found, int32_t* __restrict__ above,
                    int32_t* __restrict__ below,
                    long long* __restrict__ sum_maxes) {
  constexpr int G = kClassifyGroup;
  __shared__ spn::CharTab tab;
  spn::load_char_tab(tab, tab_g, sq);
  __syncthreads();
  const long long b =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (b >= B) return;  // the whole group leaves together
  const int lane = (int)(threadIdx.x & (G - 1));
  const long long len64 = lens[b];
  const int len = (int)(len64 < 0 ? 0 : len64 > L ? L : len64);
  const uint8_t* rd = reads + b * L;  // reversed read, left-aligned
  spn::BinMax bins(len, bin_width, thr);
  Carry st = seed(s);
  int qn = len > 0 ? __ldg(rd) : 0;  // the next step's code
  for (int t = 0; t < len; ++t) {
    const int qc = qn;
    if (t + 1 < len) qn = __ldg(rd + t + 1);
    int sample, doc;
    group_step<kPml, G>(row_of(blocks, s, st.cand), s, tab, qc, lane, st,
                        sample, doc);
    bins.add(t, st.length);
  }
  if (lane == 0) bins.finish(found + b, above + b, below + b, sum_maxes + b);
}

unsigned grid_of(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

// The layout scalars shared by both entry points; false for a P or a row
// width this file does not take.
bool layout(long long nb, int P, int W, int T0, int n, Scalars& s) {
  if (P < 1 || (P & (P - 1)) || nb < 1 || n < 1) return false;
  const int nwords = (P + 1 + 7) / 8;
  if (T0 != kW0 + nwords || W < T0 + P) return false;
  s.nb = nb;
  s.P = P;
  s.logP = 0;
  while ((1 << s.logP) < P) ++s.logP;
  s.W = W;
  s.T0 = T0;
  s.S0 = s.D0 = -1;
  s.n = n;
  return true;
}

struct ScanArgs {
  const uint32_t* blocks;
  const long long* tab;
  int sq;
  const uint8_t* reads;
  const long long* lens;
  long long B, L;
  Scalars s;
  int32_t* vals;
  int32_t* docs;
  cudaStream_t stream;
};

template <int MODE>
void launch_scan(const ScanArgs& a) {
  occ_scan_kernel<MODE><<<grid_of(a.B * kGroup), kThreads, 0, a.stream>>>(
      a.blocks, a.tab, a.sq, a.reads, a.lens, a.B, a.L, a.s, a.vals, a.docs);
}

}  // namespace

extern "C" int spn_occ_scan(const void* blocks, long long nb, int P, int W,
                            int T0, int S0, int D0, int n,
                            int last_run_sample, int last_run_edoc,
                            int first_run_sdoc, const void* tab, int sq,
                            const void* reads, const void* lens, long long B,
                            long long L, int mode, void* vals, void* docs,
                            void* stream) {
  if (B == 0) return 0;
  ScanArgs a = {};
  if (!layout(nb, P, W, T0, n, a.s) || sq < 1 || sq > spn::kTabRows)
    return kUnsupported;
  const bool is_ms = mode == kMs || mode == kMsDoc;
  const bool doc = mode == kPmlDoc || mode == kMsDoc;
  // the MS modes read the sample columns, the doc modes the doc columns
  if ((is_ms && (S0 < T0 + P || S0 + 2 * P > W)) ||
      (doc && (D0 < T0 + P || D0 + 2 * P > W)))
    return kUnsupported;
  a.s.S0 = S0;
  a.s.D0 = D0;
  a.s.last_run_sample = last_run_sample;
  a.s.last_run_edoc = last_run_edoc;
  a.s.first_run_sdoc = first_run_sdoc;
  a.blocks = (const uint32_t*)blocks;
  a.tab = (const long long*)tab;
  a.sq = sq;
  a.reads = (const uint8_t*)reads;
  a.lens = (const long long*)lens;
  a.B = B;
  a.L = L;
  a.vals = (int32_t*)vals;
  a.docs = (int32_t*)docs;
  a.stream = (cudaStream_t)stream;
  switch (mode) {
    case kPml: launch_scan<kPml>(a); break;
    case kPmlDoc: launch_scan<kPmlDoc>(a); break;
    case kMs: launch_scan<kMs>(a); break;
    case kMsDoc: launch_scan<kMsDoc>(a); break;
    default: return kUnsupported;
  }
  return (int)cudaGetLastError();
}

extern "C" int spn_occ_classify(const void* blocks, long long nb, int P,
                                int W, int T0, int n, const void* tab, int sq,
                                const void* reads, const void* lens,
                                long long B, long long L, long long thr,
                                int bin_width, void* found, void* above,
                                void* below, void* sum_maxes, void* stream) {
  if (B == 0) return 0;
  Scalars s = {};
  if (!layout(nb, P, W, T0, n, s) || sq < 1 || sq > spn::kTabRows ||
      bin_width <= 0)
    return kUnsupported;
  occ_classify_kernel<<<grid_of(B * kClassifyGroup), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, (const long long*)tab, sq,
      (const uint8_t*)reads, (const long long*)lens, B, L, s, thr, bin_width,
      (uint8_t*)found, (int32_t*)above, (int32_t*)below,
      (long long*)sum_maxes);
  return (int)cudaGetLastError();
}
