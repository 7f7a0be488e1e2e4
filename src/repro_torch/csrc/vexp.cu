// Elementwise exponential under the policy's backend.
//
// Replaces: repro/kernels/vexp/kernel.py, vexp_2d (_vexp_kernel), the
// tiled (256, 512) Pallas pass that ops.py fed with 512-lane rows.
// Bound on this card: bytes. One read and one write per element (8 B for
// f32, 4 B for bf16) against a few dozen integer and f32 operations, far
// below the ~295 operations per byte where compute would bind.
// Design: a grid-stride loop over the flat array, one element per thread
// per step, neighbouring threads on neighbouring addresses so every load
// and store is coalesced; no tiling is needed, since nothing is reused.
// The same device helpers (vexp.cuh) are inlined by the attention kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vexp.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vexp_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                long long n, int backend) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    y[i] = vexp::apply_exp(backend, x[i]);
}

__global__ void __launch_bounds__(kThreads)
vexp_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ y, long long n, int backend) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    y[i] = __float2bfloat16_rn(
        vexp::apply_exp(backend, __bfloat162float(x[i])));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it).
extern "C" int vexp_launch(const void* x, void* y, long long n, int dtype,
                           int backend, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    vexp_f32_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, backend);
  else
    vexp_bf16_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(y), n, backend);
  return (int)cudaGetLastError();
}
