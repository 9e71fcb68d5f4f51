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
// Bound: each step is one load whose address comes from the previous one,
// so the kernel is latency-bound. The TPU kernel keeps the 4.98 MB table in
// VMEM; here it stays in device memory and lives in the 50 MB L2 after the
// first touches. One thread per element keeps its index in a register for
// all steps; R * W threads in flight hide the load latency.
//
// Plain C interface (bound with ctypes); returns cudaGetLastError() after
// the launch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_chase_kernel(const uint32_t* __restrict__ table,
                    const int32_t* __restrict__ idx0, int R, int W, int steps,
                    int32_t* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)R * W) return;
  const int j = (int)(e % W);
  int idx = idx0[e];
  for (int t = 0; t < steps; ++t) {
    const int row = idx < 0 ? idx + R : idx;
    const int nxt = (int)__ldg(table + (long long)row * W + j) ^ idx;
    const int a = nxt == INT_MIN ? INT_MIN : (nxt < 0 ? -nxt : nxt);
    idx = a % R;
  }
  out[e] = idx;
}

}  // namespace

extern "C" int spn_gather_chase(const void* table, const void* idx0, int R,
                                int W, int steps, void* out, void* stream) {
  const long long n = (long long)R * W;
  if (n == 0) return 0;
  gather_chase_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                        0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int32_t*)idx0, R, W, steps,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
