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
//        launch on the same stream, only when k > 0; triples outside
//        [B, 4Q] are dropped, and their order does not matter.
//   K12: [B, H] u8 of nibbles (the low nibble first) -> [B, 2H] u8, each
//        nibble through a 16-entry byte table (the identity for a plain
//        unpack).
//
// Both write 0 at every column at or past lens[row], where the JAX decode
// writes ranks[0] (K11) or the padding nibble's value: a decoded row then
// equals, byte for byte, the 8-bit row staging would have uploaded.
//
// Bound: bytes. Each pass reads the packed rows once and writes B * L
// bytes. One body, decode_rows, serves both kernels (the decoder, Codes2 or
// Codes4, is the only difference). A block of 256 threads takes whole rows:
// a row's 16-byte vectors go to a power-of-two group of neighbouring lanes
// (blockDim.x, chosen by the entry point from the width), so the row comes
// from the grid, with no divide, and each thread loads lens[row] once.
// Each thread issues the 16-byte loads of kVectors vectors together and
// puts them in shared memory; then each lane decodes 16-byte output chunks
// of its row's part of the warp, chunk x + g * q of a part of g lanes, so
// that each of the 4 (K11) or 2 (K12) 16-byte stores a vector makes covers
// neighbouring addresses across the lanes (a vector's own 64 or 32 output
// bytes would put one lane's stores 64 or 32 bytes apart). The look-ups
// are byte permutes (PRMT): K11's 4-entry table is one word, a packed
// byte's four codes spread into four selector nibbles; K12's 16 entries are
// two 8-byte halves, a nibble's bit 3 picking the half by one more
// permute. A vector wholly past the read is not loaded, a chunk wholly
// inside it stores without a mask, and only the one across the read's end
// masks its words. Staged rows (L a power of two from 128, or a multiple of
// 4,096) have widths of whole vectors; a width that is not, or a base that
// is not 16-byte aligned, leaves each row a head and a tail of under 16
// packed bytes, decoded one byte a lane, and where the output chunks then
// fall off 16-byte boundaries they go out as 2-byte stores.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// 16-byte packed vectors a thread has in flight, their loads issued together
constexpr int kVectors = 2;

// K11's decoder: a packed byte's four 2-bit codes (the low bits first)
// through the 4-entry table `values` (code c in byte c).
struct Codes2 {
  static constexpr int kOut = 4;  // output bytes a packed byte
  uint32_t values;

  // the four words of packed word p's bytes 0..3, in order
  __device__ __forceinline__ void words(uint32_t p, uint32_t* w) const {
    // the codes of bytes 0 and 2 (then 1 and 3) into selector nibbles
    uint32_t e = p & 0x00FF00FFu, o = (p >> 8) & 0x00FF00FFu;
    e = (e | (e << 4)) & 0x0F0F0F0Fu;
    o = (o | (o << 4)) & 0x0F0F0F0Fu;
    e = (e | (e << 2)) & 0x33333333u;
    o = (o | (o << 2)) & 0x33333333u;
    w[0] = __byte_perm(values, 0, e);
    w[1] = __byte_perm(values, 0, o);
    w[2] = __byte_perm(values, 0, e >> 16);
    w[3] = __byte_perm(values, 0, o >> 16);
  }
};

// K12's decoder: a packed byte's two nibbles (the low one first) through
// the 16-entry table lo (nibbles 0-7) and hi (8-15), four bytes a word.
struct Codes4 {
  static constexpr int kOut = 2;
  uint32_t lo0, lo1, hi0, hi1;

  // the output word of the four nibbles in the low 16 bits of q
  __device__ __forceinline__ uint32_t word(uint32_t q) const {
    const uint32_t s = q & 0x7777u;  // a nibble's index in its half
    const uint32_t a = __byte_perm(lo0, lo1, s), b = __byte_perm(hi0, hi1, s);
    // byte k from b where nibble k has bit 3 set, else from a
    return __byte_perm(a, b, 0x3210u | ((q >> 1) & 0x4444u));
  }
  // the two words of packed word p's bytes 0..3, in order
  __device__ __forceinline__ void words(uint32_t p, uint32_t* w) const {
    w[0] = word(p);
    w[1] = word(p >> 16);
  }
};

// w &= the bytes at columns col .. col + 3 below n
__device__ __forceinline__ uint32_t below(uint32_t w, long long col,
                                          long long n) {
  const long long keep = n - col;
  return keep >= 4 ? w : keep <= 0 ? 0u : w & ((1u << (8 * keep)) - 1u);
}

// Rows blockIdx.x * blockDim.y + threadIdx.y, each over blockDim.x lanes:
// the whole-vector middle of a row, then its head and tail. vec: the middle
// chunks' outputs lie on 16-byte boundaries (the entry point's check).
template <class D>
__device__ __forceinline__ void decode_rows(
    const uint8_t* __restrict__ packed, const int64_t* __restrict__ lens,
    long long B, long long W, const D& d, bool vec,
    uint8_t* __restrict__ out) {
  constexpr int kIn = 4 / D::kOut;  // packed words of a 16-byte chunk
  __shared__ uint4 stage[kThreads / 32][kVectors][32];
  const int x = threadIdx.x, tx = blockDim.x;
  const int lane = (threadIdx.y * tx + x) & 31;
  // the warp's lanes of this row: g of them from lane s0
  const int g = tx < 32 ? tx : 32, xs = x & (g - 1), s0 = lane - xs;
  uint4(*st)[32] = stage[(threadIdx.y * tx + x) >> 5];
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < B;  // dead lanes still keep the warp's steps
  const uint8_t* in = packed + row * W;
  uint8_t* o = out + row * W * D::kOut;
  const long long n = live ? __ldg(lens + row) : 0;  // decoded: cols < n
  const long long h =
      min((long long)((16 - ((uintptr_t)in & 15)) & 15), W);  // head bytes
  const long long m = (W - h) >> 4;                          // vectors
  // every row of the block takes the same steps: m <= W / 16
  for (long long jb = 0; jb < W >> 4; jb += (long long)tx * kVectors) {
    uint4 v[kVectors];
#pragma unroll
    for (int u = 0; u < kVectors; ++u) {
      const long long j = jb + (long long)u * tx + x;
      v[u] = live && j < m && (h + 16 * j) * D::kOut < n
                 ? __ldg(reinterpret_cast<const uint4*>(in + h + 16 * j))
                 : make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kVectors; ++u) st[u][lane] = v[u];
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kVectors; ++u) {
      const long long j0 = jb + (long long)u * tx + x - xs;  // part's first
      const uint32_t* words = reinterpret_cast<const uint32_t*>(st[u] + s0);
#pragma unroll
      for (int r = 0; r < D::kOut; ++r) {
        // the parts of a warp take their chunks in turn: no bank conflict
        const int q = (r + s0 / g) % D::kOut;
        const int c = xs + g * q;  // chunk of the part
        if (!live || j0 + c / D::kOut >= m) continue;
        const long long col = (h + 16 * j0) * D::kOut + 16 * c;
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < kIn; ++i)
          d.words(words[kIn * c + i], w + i * D::kOut);
        if (col + 16 > n) {  // across or past the read's end
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = below(w[i], col + 4 * i, n);
        }
        if (vec) {
          *reinterpret_cast<uint4*>(o + col) = make_uint4(w[0], w[1], w[2],
                                                          w[3]);
        } else {
          uint16_t* dst = reinterpret_cast<uint16_t*>(o + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dst[2 * i] = (uint16_t)w[i];
            dst[2 * i + 1] = (uint16_t)(w[i] >> 16);
          }
        }
      }
    }
  }
  if (!live) return;
  // head [0, h) and tail [h + 16m, W): one packed byte a lane
  const long long t0 = h + 16 * m, rest = h + (W - t0);
  for (long long k = x; k < rest; k += tx) {
    const long long i = k < h ? k : t0 + (k - h);
    const long long c = i * D::kOut;
    uint32_t w[D::kOut];
    d.words(__ldg(in + i), w);
    const uint32_t b = below(w[0], c, n);
    if (D::kOut == 4) {
      *reinterpret_cast<uint32_t*>(o + c) = b;  // 4-byte aligned: 4W rows
    } else {
      *reinterpret_cast<uint16_t*>(o + c) = (uint16_t)b;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
unpack2_kernel(const uint8_t* __restrict__ packed,
               const int64_t* __restrict__ lens, long long B, long long Q,
               Codes2 d, bool vec, uint8_t* __restrict__ out) {
  decode_rows(packed, lens, B, Q, d, vec, out);
}

__global__ void __launch_bounds__(kThreads)
unpack4_kernel(const uint8_t* __restrict__ packed,
               const int64_t* __restrict__ lens, long long B, long long H,
               Codes4 d, bool vec, uint8_t* __restrict__ out) {
  decode_rows(packed, lens, B, H, d, vec, out);
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

// Launches `kernel` over B rows of W packed bytes: blockDim.x lanes a row,
// the least power of two that covers its vectors kVectors a lane (at most
// kThreads), blockDim.y = kThreads / blockDim.x rows a block.
template <class D>
void launch_rows(void (*kernel)(const uint8_t*, const int64_t*, long long,
                                long long, D, bool, uint8_t*),
                 const void* packed, const void* lens, long long B,
                 long long W, const D& d, void* out, cudaStream_t st) {
  const long long lanes = (W / 16 + kVectors - 1) / kVectors;
  int tx = 1;
  while (tx < lanes && tx < kThreads) tx *= 2;
  const int ty = kThreads / tx;
  // every row's middle starts where packed + row * W + h is 16-byte
  // aligned, so its output chunks lie at out - kOut * packed modulo 16
  const bool vec =
      (((uintptr_t)out - (uintptr_t)D::kOut * (uintptr_t)packed) & 15) == 0;
  kernel<<<(unsigned)((B + ty - 1) / ty), dim3(tx, ty), 0, st>>>(
      (const uint8_t*)packed, (const int64_t*)lens, B, W, d, vec,
      (uint8_t*)out);
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
    launch_rows(unpack2_kernel, packed, lens, B, Q, Codes2{values}, out, st);
  }
  if (k > 0) {
    scatter_exceptions_kernel<<<(unsigned)((k + kThreads - 1) / kThreads),
                                kThreads, 0, st>>>(
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
    launch_rows(unpack4_kernel, packed, lens, B, H,
                Codes4{(uint32_t)tab_lo, (uint32_t)(tab_lo >> 32),
                       (uint32_t)tab_hi, (uint32_t)(tab_hi >> 32)},
                out, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
