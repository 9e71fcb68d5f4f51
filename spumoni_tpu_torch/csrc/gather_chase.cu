// K6 `gather_chase`: the dependent gather chase of the VMEM-gather
// microbenchmark, on NVIDIA Hopper (sm_90a).
//
// Replaces scripts/exp_vmem_gather.py::run_pallas -> chase_kernel (the
// repo's only pl.pallas_call). Per element (i, j) of an [R, W] index
// matrix, `steps` dependent steps of
//     idx = rem(abs(int32(table[idx, j]) ^ idx), R)
// with jnp.abs's two's-complement wrap (abs(INT_MIN) == INT_MIN) and
// lax.rem's sign rule (the result takes the dividend's sign), so idx can go
// negative; a negative index reads row idx + R, as take_along_axis does.
//
// Design. Chain (i, j) reads column j of the table and nothing else. So a
// block owns a group of kCols neighbouring columns and a slice of the
// rows: it first copies its columns, all R rows, into dynamic shared
// memory, compacted to R x kCols words (one kCols-word vector load a row),
// and then runs its slice's chains from there, kChains interleaved in
// each thread. Neighbouring lanes take neighbouring columns, so a warp's
// words spread over all 32 banks. This is the TPU kernel's VMEM-resident
// table (in_specs memory_space=VMEM), one column group a block. The grid
// is the column groups times as many row slices as fill the SMs in one
// wave: at R = 9,728 and kCols = 4 a block holds 155.6 KB, one block an
// SM, 32 x 4 blocks. Where kCols columns do not fit the opt-in limit (R >
// 14,528 on an H100) a block holds one column, up to R = 58,112 (227 KB).
// The caller chooses the column count from the device's limit
// (kernels.chase_cols; the wrapper raises past the capacity). The step
// is integer work around one shared-memory load, so it is kept short:
// the remainder by R is a multiply-high by a multiplier and shift
// computed on the host (kernels._chase_magic, exact for every |a| in [0,
// 2^31]) and one multiply-add by -R, and abs(INT_MIN) == INT_MIN, the
// only dividend whose remainder lax.rem makes negative, takes its index
// and row from two constants of R by one compare.
//
// Read through L2 instead, one thread an element (the port's first form),
// every step took a 32-byte sector for 4 useful bytes: 0.55-0.57 ms at
// the script's shape on an H100, bound by L2 sector throughput.
//
// Bound at the script's shape (R = 9,728, W = 128, 64 steps: 79.7 M
// steps). (1) The roofline (chip_smoke.py's `_bound`), every byte once
// and 4 operations a step at 67 T/s: 0.0048 ms (operations). (2) One
// 4-byte shared-memory word a step, 32 banks a clock on 132 SMs at 1.98
// GHz: 0.0095 ms. (3) The rows of a warp's 32 lanes are random, so their
// words meet in banks: at 4 columns a row the fullest bank holds 3.29
// words on average (3.53 at one column), and a warp's load takes that many
// passes: 0.031 ms. No layout avoids (3): the data decides the rows. The
// kernel is held to (3), which chip_smoke.py and exp_vmem_gather report
// as floor_ms. Above it, on an H100: the step's integer instructions
// (about a dozen around the load) and the copy (about 10 us: each 16-byte
// row read takes a 32-byte sector from L2).
//
// Plain C interface (bound with ctypes); returns cudaGetLastError() after
// the launch, -1 for a column count it does not instantiate.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 1024;
constexpr int kCols = 4;    // columns a block holds where they fit
                            // (kernels.CHASE_COLS)
constexpr int kChains = 2;  // chains a thread carries, interleaved
constexpr int kUnsupported = -1;

template <int C>
struct Row;  // the C words of one table row in a block's columns
template <>
struct Row<1> { using T = uint32_t; };
template <>
struct Row<4> { using T = uint4; };

// R with its remainder by multiply-high: q = (umulhi(u, magic) + u) >>
// shift is u / R for u <= 2^31 (the sum fits: umulhi(u, magic) < u), and
// u - q R is one multiply-add with neg_r = -R an argument
struct Divisor {
  int R;
  unsigned magic;
  int shift;
  unsigned neg_r;
  __device__ __forceinline__ unsigned rem(unsigned u) const {
    return u + neg_r * ((__umulhi(u, magic) + u) >> shift);
  }
};

// K chains of a block's slice, q, q + kThreads, ...: each chain's start
// index from idx0, `steps` steps on the block's columns, its last index
// to out
template <int C, int K>
__device__ __forceinline__ void run_chains(
    const uint32_t* cols, const int32_t* __restrict__ idx0,
    int32_t* __restrict__ out, int q, int r0, int cw, int W, int j0,
    int steps, const Divisor& d) {
  long long e[K];
  const uint32_t* col[K];
  int idx[K], row[K];
  // abs(INT_MIN) == INT_MIN is the only negative dividend, and lax.rem
  // keeps its sign: its index and row are constants of R
  const int wrap_idx = -(int)d.rem(0x80000000u);
  const int wrap_row = wrap_idx < 0 ? wrap_idx + d.R : 0;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const unsigned c = (unsigned)(q + u * kThreads);
    const unsigned i = cw == C ? c / C : c / (unsigned)cw;
    const int k = (int)(c - i * cw);
    e[u] = (long long)(r0 + (int)i) * W + j0 + k;
    col[u] = cols + k;
    idx[u] = __ldg(idx0 + e[u]);
    row[u] = idx[u] < 0 ? idx[u] + d.R : idx[u];
  }
  for (int t = 0; t < steps; ++t) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int nxt = (int)col[u][row[u] * C] ^ idx[u];
      const int r =
          (int)d.rem(nxt < 0 ? 0u - (unsigned)nxt : (unsigned)nxt);
      idx[u] = nxt == INT_MIN ? wrap_idx : r;
      row[u] = nxt == INT_MIN ? wrap_row : r;
    }
  }
#pragma unroll
  for (int u = 0; u < K; ++u) out[e[u]] = idx[u];
}

// Block (g, s): columns [g C, g C + cw) (cw < C only in the last group),
// rows [s rows_per_block, ...) of them.
template <int C>
__global__ void __launch_bounds__(kThreads)
gather_chase_kernel(const uint32_t* __restrict__ table,
                    const int32_t* __restrict__ idx0, int R, int W,
                    int steps, Divisor d, int rows_per_block,
                    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t cols[];  // [R][C]
  using V = typename Row<C>::T;
  const int j0 = blockIdx.x * C;
  const int cw = min(C, W - j0);
  const int r0 = blockIdx.y * rows_per_block;
  const int n = (min(R, r0 + rows_per_block) - r0) * cw;  // the chains
  if (cw == C && W % C == 0 &&
      reinterpret_cast<uintptr_t>(table) % sizeof(V) == 0) {
#pragma unroll 4
    for (int r = threadIdx.x; r < R; r += kThreads)
      reinterpret_cast<V*>(cols)[r] =
          __ldg(reinterpret_cast<const V*>(table + (long long)r * W + j0));
  } else {
    for (int c = threadIdx.x; c < R * cw; c += kThreads) {
      const int r = c / cw, k = c - r * cw;
      cols[r * C + k] = __ldg(table + (long long)r * W + j0 + k);
    }
  }
  __syncthreads();
  int q = threadIdx.x;
  for (; q + (kChains - 1) * kThreads < n; q += kChains * kThreads)
    run_chains<C, kChains>(cols, idx0, out, q, r0, cw, W, j0, steps, d);
  for (; q < n; q += kThreads)
    run_chains<C, 1>(cols, idx0, out, q, r0, cw, W, j0, steps, d);
}

// What a launch asks of the host, kept per device and instantiation: the
// SM count, the shared-memory opt-in (set once, to the device's limit),
// and the blocks an SM holds at the last launch's shared memory.
struct LaunchCache {
  int sms = 0;
  int smem = -1;
  int per_sm = 0;
};
constexpr int kMaxDevices = 64;
std::mutex cache_lock;

template <int C>
int launch(const uint32_t* table, const int32_t* idx0, int R, int W,
           int steps, const Divisor& d, int32_t* out, cudaStream_t st) {
  static LaunchCache caches[kMaxDevices];
  const int smem = R * C * (int)sizeof(uint32_t);
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= kMaxDevices) return kUnsupported;
  {
    std::lock_guard<std::mutex> hold(cache_lock);
    LaunchCache& c = caches[dev];
    if (c.sms == 0) {
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (rc == cudaSuccess)
        rc = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (rc == cudaSuccess)
        rc = cudaFuncSetAttribute(gather_chase_kernel<C>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin);
      if (rc != cudaSuccess) return (int)rc;
      c.sms = sms;
    }
    if (c.smem != smem) {
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_chase_kernel<C>, kThreads, smem);
      if (rc != cudaSuccess) return (int)rc;
      c.smem = smem;
      c.per_sm = per_sm;
    }
    sms = c.sms;
    per_sm = c.per_sm;
  }
  const int groups = (W + C - 1) / C;
  // row slices: as many as fill the SMs in one wave, at least one
  const int slices = max(1, min(R, sms * per_sm / groups));
  const int rows = (R + slices - 1) / slices;
  gather_chase_kernel<C><<<dim3(groups, (R + rows - 1) / rows), kThreads,
                           smem, st>>>(table, idx0, R, W, steps, d, rows,
                                       out);
  return (int)cudaGetLastError();
}

}  // namespace

// table: [R, W] u32, idx0 / out: [R, W] int32, idx0 in [-R, R); (magic,
// shift) from kernels._chase_magic(R); cols, the columns a block holds,
// from kernels.chase_cols(R) (kCols or 1).
extern "C" int spn_gather_chase(const void* table, const void* idx0, int R,
                                int W, int steps, unsigned magic, int shift,
                                int cols, void* out, void* stream) {
  if ((long long)R * W == 0) return 0;
  const Divisor d{R, magic, shift, 0u - (unsigned)R};
  const uint32_t* t = (const uint32_t*)table;
  const int32_t* i0 = (const int32_t*)idx0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cols == kCols)
    return launch<kCols>(t, i0, R, W, steps, d, (int32_t*)out, st);
  if (cols == 1) return launch<1>(t, i0, R, W, steps, d, (int32_t*)out, st);
  return kUnsupported;
}
