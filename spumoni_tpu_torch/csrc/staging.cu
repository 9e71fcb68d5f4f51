// K11 `unpack2` and K12 `unpack4`: the device decode of the read rows that
// staging uploads packed at 2 or 4 bits, on NVIDIA Hopper (sm_90a).
//
// Replaces spumoni_tpu/engine/scan_engine.py::_unpack2 (K11) and _unpack4
// with _decode_alpha (K12; the 16-entry byte table does _decode_alpha).
//
//   K11: [B, Q] u8 of 2-bit codes (four per byte, the low bits first) ->
//        [B, 4Q] u8: each code through a 4-entry value table (the ranks of
//        A, C, G, T, or their raw bytes), then the [k, 3] int32 (row, col,
//        value) exception triples written over their cells in a second
//        launch on the same stream; triples outside [B, 4Q] are dropped.
//   K12: [B, H] u8 of nibbles (the low nibble first) -> [B, 2H] u8, each
//        nibble through a 16-entry byte table (the identity for a plain
//        unpack).
//
// Both write 0 at every column at or past lens[row], where the JAX decode
// writes ranks[0] (K11) or the padding nibble's value: a decoded row then
// equals, byte for byte, the 8-bit row staging would have uploaded.
//
// Bound: bytes. Each byte pass reads the packed rows once and writes B * L
// bytes; one thread per packed byte keeps a warp's loads on 32 neighbouring
// bytes and its stores on 128 (K11) or 64 (K12) neighbouring bytes, as one
// 4- or 2-byte store a thread. The tables are kernel arguments held in
// registers (a 32-bit word, two 64-bit words) and read by shifts.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
unpack2_kernel(const uint8_t* __restrict__ packed,
               const int64_t* __restrict__ lens, long long B, long long Q,
               uint32_t values, uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * Q) return;
  const long long row = i / Q;
  const long long col = 4 * (i - row * Q);
  const long long len = __ldg(lens + row);
  const uint32_t b = __ldg(packed + i);
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t code = (b >> (2 * k)) & 3u;
    const uint32_t v = col + k < len ? (values >> (8 * code)) & 0xFFu : 0u;
    word |= v << (8 * k);
  }
  // out row stride 4Q: out + 4i is 4-byte aligned
  reinterpret_cast<uint32_t*>(out)[i] = word;
}

__global__ void __launch_bounds__(kThreads)
scatter_exceptions_kernel(const int32_t* __restrict__ exc, long long k,
                          long long B, long long L,
                          uint8_t* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= k) return;
  const long long row = exc[3 * e], col = exc[3 * e + 1];
  if (row < 0 || row >= B || col < 0 || col >= L) return;
  out[row * L + col] = (uint8_t)exc[3 * e + 2];
}

__global__ void __launch_bounds__(kThreads)
unpack4_kernel(const uint8_t* __restrict__ packed,
               const int64_t* __restrict__ lens, long long B, long long H,
               unsigned long long tab_lo, unsigned long long tab_hi,
               uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const long long row = i / H;
  const long long col = 2 * (i - row * H);
  const long long len = __ldg(lens + row);
  const uint32_t b = __ldg(packed + i);
  uint32_t pair = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t nib = (b >> (4 * k)) & 15u;
    const unsigned long long half = nib < 8 ? tab_lo : tab_hi;
    const uint32_t v =
        col + k < len ? (uint32_t)(half >> (8 * (nib & 7u))) & 0xFFu : 0u;
    pair |= v << (8 * k);
  }
  // out row stride 2H: out + 2i is 2-byte aligned
  reinterpret_cast<uint16_t*>(out)[i] = (uint16_t)pair;
}

unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// packed [B, Q] u8, lens [B] int64, values: the 4-entry table as bytes of a
// 32-bit word (code c in bits 8c..8c+7), exc [k, 3] int32 (or k == 0),
// out [B, 4Q] u8.
extern "C" int spn_unpack2(const void* packed, const void* lens, long long B,
                           long long Q, unsigned values, const void* exc,
                           long long k, void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (B * Q > 0) {
    unpack2_kernel<<<blocks(B * Q), kThreads, 0, st>>>(
        (const uint8_t*)packed, (const int64_t*)lens, B, Q, values,
        (uint8_t*)out);
  }
  if (k > 0) {
    scatter_exceptions_kernel<<<blocks(k), kThreads, 0, st>>>(
        (const int32_t*)exc, k, B, 4 * Q, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

// packed [B, H] u8, lens [B] int64, the 16-entry table as bytes of two
// 64-bit words (nibble v in bits 8(v % 8).. of tab_lo for v < 8, else of
// tab_hi), out [B, 2H] u8.
extern "C" int spn_unpack4(const void* packed, const void* lens, long long B,
                           long long H, unsigned long long tab_lo,
                           unsigned long long tab_hi, void* out,
                           void* stream) {
  if (B * H > 0) {
    unpack4_kernel<<<blocks(B * H), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const int64_t*)lens, B, H, tab_lo, tab_hi,
        (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
