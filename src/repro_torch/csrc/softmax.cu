// Fused row softmax with the policy's exponential.
//
// Replaces: repro/kernels/softmax/kernel.py, softmax_rows (_softmax_kernel),
// the paper's Softmax kernel: the row max; exp(x - max) with the sum
// taken in the same pass; one reciprocal per row, then a multiply (never
// a per-element divide). Math in f32, output in the input's dtype. No
// guard for a row masked everywhere (the Pallas kernel has none; only
// core.softmax has it).
//
// Bound on this card: bytes. Each element is read once and written once
// (8 B in f32) against a few dozen operations, far below the ~295
// operations per byte where compute would bind.
// Design: one CTA per row. The row is read once from device memory into
// dynamic shared memory as f32 (taking its max on the way), exp(x - max)
// overwrites it in shared memory while each thread sums its own lanes,
// and the normalised row is written once. Threads stride over the row,
// so neighbouring threads touch neighbouring addresses. The reference
// pads each row to a lane multiple with NEG_INF, whose exp is exactly 0;
// this kernel walks exactly n lanes, which gives the same sum. Rows up to
// the shared-memory limit (about 58,000 f32 lanes) are taken; the wrapper
// checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vexp.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Block-wide reduction; every thread returns the result. `red` holds one
// float per warp and is free again when this returns.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : __fadd_rn(v, o);
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red[lane] : (kMax ? neg_inf() : 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = kMax ? fmaxf(v, o) : __fadd_rn(v, o);
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
softmax_kernel(const T* __restrict__ x, T* __restrict__ y, int n,
               int backend) {
  extern __shared__ float smem[];
  float* red = smem;                       // 32 floats
  float* row = smem + 32;                  // n floats
  const long long off = (long long)blockIdx.x * n;
  const T* xr = x + off;
  T* yr = y + off;

  float mx = neg_inf();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = load(xr + i);
    row[i] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_reduce<true>(mx, red);        // its syncs publish `row`

  float sum = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float e = vexp::apply_exp(backend, __fsub_rn(row[i], mx));
    row[i] = e;
    sum = __fadd_rn(sum, e);
  }
  sum = block_reduce<false>(sum, red);

  const float inv = 1.0f / sum;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    store(yr + i, __fmul_rn(row[i], inv));
}

}  // namespace

// Dynamic shared memory bytes a row of n lanes needs.
extern "C" long long softmax_smem_bytes(int n) {
  return (long long)sizeof(float) * (32LL + n);
}

// x, y: (rows, n) packed, both float32 (dtype 0) or bfloat16 (dtype 1).
// Returns cudaGetLastError() after the launch.
extern "C" int softmax_fwd(const void* x, void* y, long long rows, int n,
                           int dtype, int backend, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  int threads = 32;
  while (threads < n && threads < kMaxThreads) threads *= 2;
  const size_t smem = (size_t)softmax_smem_bytes(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(softmax_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    softmax_kernel<float><<<(unsigned)rows, threads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, backend);
  } else {
    err = cudaFuncSetAttribute(softmax_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    softmax_kernel<__nv_bfloat16><<<(unsigned)rows, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(y), n, backend);
  }
  return (int)cudaGetLastError();
}
