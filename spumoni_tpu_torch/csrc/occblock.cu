// K9 `occ_scan` and K10 `occ_classify`: the PML / MS / doc recurrence over
// the occ-block index (engine v3), one thread per read, on NVIDIA Hopper
// (sm_90a).
//
// Replaces (JAX package, jitted XLA scans on the TPU):
//   K9:  spumoni_tpu/engine/scan_engine.py::query_batch_kernel_v3 (the step
//        of engine/occblock.py::make_occ_step_fn scanned over the read from
//        occ_initial_state, its sentinel step and realignment) and the
//        per-lane flip of _flip_rows: K9 writes forward order, in four
//        modes: PML, PML+doc, MS (the sample pointers), MS+doc.
//   K10: spumoni_tpu/parallel/mesh.py::fused_classify_kernel with the occ
//        step: K9's PML scan with the windowed bin-max folded into the carry
//        (binmax.cuh, shared with K2 and K8).
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
// Bound: a step is ONE dependent random row read (the next candidate comes
// from it), so a lane is a pointer chase and the kernel is latency-bound.
// One thread per read keeps the carry in registers for the whole read in
// one launch (long reads included), 128-thread blocks let a whole batch be
// resident, the per-character table sits in shared memory, and a step reads
// only the row words it needs: the threshold, the checkpoint, the char
// words up to the offset (a SWAR zero-nibble test and __popc per word) and,
// when the previous step jumped, one sample and one doc word.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launch, or kUnsupported for arguments this
// file does not take.

#include <cuda_runtime.h>

#include <cstdint>

#include "binmax.cuh"
#include "blockbits_pml.cuh"  // spn::CharTab, spn::load_char_tab

namespace {

constexpr int kThreads = 128;
constexpr int kUnsupported = -1;
constexpr int kW0 = 16;  // first char word: after the 16 checkpoints
constexpr uint32_t kNibLsb = 0x11111111u;

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

// Resolves the previous step's jump from row (cand's row) at offset off:
// returns minus1 and the previous step's sample and doc id.
template <int MODE>
__device__ __forceinline__ bool resolve(const uint32_t* __restrict__ row,
                                        const Scalars& s, const Carry& st,
                                        int off, int& sample, int& doc) {
  constexpr bool kIsMs = MODE == kMs || MODE == kMsDoc;
  constexpr bool kDoc = MODE == kPmlDoc || MODE == kMsDoc;
  const bool minus1 =
      st.forced || (st.pending && st.prev_p < (int)__ldg(row + s.T0 + off));
  const bool jumped = !st.was_match && !st.was_empty;
  sample = st.sample;
  if (kIsMs)
    sample = st.was_match ? st.sample - 1
             : st.was_empty ? 0
             : (int)__ldg(row + s.S0 + (minus1 ? s.P : 0) + off);
  doc = st.doc;
  if (kDoc) {
    if (jumped)
      doc = (int)__ldg(row + s.D0 + (minus1 ? s.P : 0) + off);
    else if (kIsMs && st.was_empty)  // compute_ms_pml.cpp:639-643
      doc = s.first_run_sdoc;        // (PML keeps the doc: :303)
  }
  return minus1;
}

// Processes query-rank code qc from the resolved position (block offset
// pos_off in [-1, P-1] of row) and moves the carry to the next candidate.
__device__ __forceinline__ void advance(const uint32_t* __restrict__ row,
                                        const spn::CharTab& tab, int qc,
                                        int p, int pos_off, Carry& st) {
  const bool empty = tab.empty[qc] == 1;
  bool is_match = false, has_next = false;
  int cand;
  if (empty) {
    cand = (int)tab.F[qc];
  } else {
    // nibble g of the char words: g = 0 prevchar, g = j + 1 offset j.
    // rank within the block = #{1 <= g <= pos_off : nib[g] == c}, i.e. the
    // count over g < e = pos_off + 1 less the prevchar's; bwt[p] = nib[e]
    const uint32_t c = (uint32_t)tab.code[qc];
    const uint32_t pat = c * kNibLsb;
    const int e = pos_off + 1;
    const int we = e >> 3;
    int cnt = 0;
    for (int w = 0; w < we; ++w)
      cnt += __popc(zero_nibbles(__ldg(row + kW0 + w) ^ pat));
    const uint32_t wl = __ldg(row + kW0 + we);
    const int sh = (e & 7) * 4;
    cnt += __popc(zero_nibbles(wl ^ pat) & ((1u << sh) - 1u));
    const uint32_t w0 = we == 0 ? wl : __ldg(row + kW0);
    cnt -= (w0 & 15u) == c ? 1 : 0;
    is_match = ((wl >> sh) & 15u) == c;
    cand = (int)__ldg(row + c) + cnt;  // F[c] + rank(p, c)
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
  __shared__ spn::CharTab tab;
  spn::load_char_tab(tab, tab_g, sq);
  __syncthreads();
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long len = lens[b];
  len = len < 0 ? 0 : len > L ? L : len;
  const uint8_t* rd = reads + b * L;  // reversed read, left-aligned
  int32_t* ov = vals + b * L + len - 1;  // forward position len-1-t
  int32_t* od = kDoc ? docs + b * L + len - 1 : nullptr;
  Carry st = seed(s);
  // lagging modes run one resolution past the last character
  const long long steps = len + ((kIsMs || kDoc) ? 1 : 0);
  for (long long t = 0; t < steps; ++t) {
    const uint32_t* row = row_of(blocks, s, st.cand);
    const int off = st.cand & (s.P - 1);
    int sample, doc;
    const bool minus1 = resolve<MODE>(row, s, st, off, sample, doc);
    if (t > 0) {  // read position t - 1: forward column len - t
      if (kIsMs) ov[1 - t] = sample;
      if (kDoc) od[1 - t] = doc;
    }
    if (t == len) break;
    st.sample = sample;
    st.doc = doc;
    advance(row, tab, __ldg(rd + t), st.cand - minus1, off - minus1, st);
    if (!kIsMs) ov[-t] = st.length;
  }
}

__global__ void __launch_bounds__(kThreads)
occ_classify_kernel(const uint32_t* __restrict__ blocks,
                    const long long* __restrict__ tab_g, int sq,
                    const uint8_t* __restrict__ reads,
                    const long long* __restrict__ lens, long long B,
                    long long L, Scalars s, long long thr, int bin_width,
                    uint8_t* __restrict__ found, int32_t* __restrict__ above,
                    int32_t* __restrict__ below,
                    long long* __restrict__ sum_maxes) {
  __shared__ spn::CharTab tab;
  spn::load_char_tab(tab, tab_g, sq);
  __syncthreads();
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long len64 = lens[b];
  const int len = (int)(len64 < 0 ? 0 : len64 > L ? L : len64);
  const uint8_t* rd = reads + b * L;
  spn::BinMax bins(len, bin_width, thr);
  Carry st = seed(s);
  for (int t = 0; t < len; ++t) {
    const uint32_t* row = row_of(blocks, s, st.cand);
    const int off = st.cand & (s.P - 1);
    int sample, doc;
    const bool minus1 = resolve<kPml>(row, s, st, off, sample, doc);
    advance(row, tab, __ldg(rd + t), st.cand - minus1, off - minus1, st);
    bins.add(t, st.length);
  }
  bins.finish(found + b, above + b, below + b, sum_maxes + b);
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
  occ_scan_kernel<MODE><<<grid_of(a.B), kThreads, 0, a.stream>>>(
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
  occ_classify_kernel<<<grid_of(B), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, (const long long*)tab, sq,
      (const uint8_t*)reads, (const long long*)lens, B, L, s, thr, bin_width,
      (uint8_t*)found, (int32_t*)above, (int32_t*)below,
      (long long*)sum_maxes);
  return (int)cudaGetLastError();
}
