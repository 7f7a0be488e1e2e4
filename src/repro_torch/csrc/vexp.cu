// Elementwise exponential under the policy's backend.
//
// Replaces: repro/kernels/vexp/kernel.py, vexp_2d (_vexp_kernel), the
// tiled (256, 512) Pallas pass that ops.py fed with 512-lane rows.
//
// What bounds each form on this card, and what the design does about it:
//  * exact and vexp, computed in f32 per element: bytes. One read and one
//    write per element (8 B f32, 4 B bf16) against the few dozen
//    instructions per element that chip_smoke.py counts in this library's
//    SASS. Holding HBM busy takes ~16-20 KB of loads in flight per SM, so
//    each thread moves 16-byte vectors (float4, or 8 x bf16 in a uint4),
//    one (f32) or four (bf16) of them loaded before its first exp, with
//    streaming cache hints (nothing is reused). The grid has one CTA per
//    step of kThreads x Vec<T>::kUnroll vectors (2 KB f32, 8 KB bf16),
//    each an equal contiguous share, so CTAs launched in order stream
//    through the array together: a persistent grid of SMs x resident CTAs
//    read slower on the H100 (tools/vexp_forms.py). One instance per
//    backend and dtype: no branch on the backend at run time.
//  * vexp_hw: its computed datapath (vexp_hw_bits) is a chain of integer
//    instructions, and Hopper's integer pipe issues half the lanes of its
//    FP32 pipe, which puts the computed form above the byte bound
//    (chip_smoke.py prints its counted instructions and that bound). But
//    vexp_hw is a function of 16 bits (it rounds f32 to bf16 first), so it
//    runs as a table: vexp_hw_table_build writes the 65,536 results once
//    per device (exact by construction: vexp_hw_bits on every pattern),
//    and each CTA of vexp_hw_table_kernel (one per SM at a time: the
//    table fills 128 KB of shared memory) copies the table from L2 with
//    TMA bulk copies on an mbarrier, loads its first vectors while the
//    table lands, then streams as above with one round to bf16 (f32
//    only), one shared-memory gather and one widen (f32 only) per element.
//  * When x or y is not 16-byte aligned (a view at an odd offset), the
//    same kernels take a scalar grid-stride loop over the whole array;
//    aligned, they take it only for the n % (vector width) tail.
// The exp helpers are vexp.cuh's, which the attention kernels inline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vexp.cuh"

namespace {

constexpr int kThreads = 128;          // computed form
constexpr int kTableThreads = 1024;    // table form: one CTA per SM
constexpr int kTableUnroll = 4;        // table form: vectors a thread
constexpr int kTableEntries = 1 << 16;
constexpr int kTableBytes = kTableEntries * 2;
constexpr int kTableCopies = 4;        // TMA bulk copies per table fill
constexpr int kMaxDevices = 64;
constexpr long long kMaxGrid = 0x7FFFFFFF;   // gridDim.x limit

struct TableSmem {
  uint16_t lut[kTableEntries];
  uint64_t bar;
};

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// ----------------------------------------------- computed form, per lane

template <int BACKEND>
__device__ __forceinline__ float exp_of(float v) {
  return vexp::apply_exp(BACKEND, v);   // BACKEND is a constant: one path
}

template <int BACKEND>
__device__ __forceinline__ float4 exp_vec(float4 v) {
  return make_float4(exp_of<BACKEND>(v.x), exp_of<BACKEND>(v.y),
                     exp_of<BACKEND>(v.z), exp_of<BACKEND>(v.w));
}

// two bf16 lanes of one 32-bit word, widened exactly, rounded back
template <int BACKEND>
__device__ __forceinline__ uint32_t exp_bf16x2(uint32_t w) {
  const float lo = exp_of<BACKEND>(__uint_as_float(w << 16));
  const float hi = exp_of<BACKEND>(__uint_as_float(w & 0xFFFF0000u));
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

template <int BACKEND>
__device__ __forceinline__ uint4 exp_vec(uint4 v) {
  return make_uint4(exp_bf16x2<BACKEND>(v.x), exp_bf16x2<BACKEND>(v.y),
                    exp_bf16x2<BACKEND>(v.z), exp_bf16x2<BACKEND>(v.w));
}

template <int BACKEND>
__device__ __forceinline__ float exp_scalar(float v) {
  return exp_of<BACKEND>(v);
}

template <int BACKEND>
__device__ __forceinline__ __nv_bfloat16 exp_scalar(__nv_bfloat16 v) {
  return __float2bfloat16_rn(exp_of<BACKEND>(__bfloat162float(v)));
}

// ------------------------------------------------- table form, per lane

__device__ __forceinline__ float4 lookup_vec(const uint16_t* lut,
                                             float4 v) {
  return make_float4(
      __uint_as_float((uint32_t)lut[bf16_bits(v.x)] << 16),
      __uint_as_float((uint32_t)lut[bf16_bits(v.y)] << 16),
      __uint_as_float((uint32_t)lut[bf16_bits(v.z)] << 16),
      __uint_as_float((uint32_t)lut[bf16_bits(v.w)] << 16));
}

__device__ __forceinline__ uint32_t lookup_bf16x2(const uint16_t* lut,
                                                  uint32_t w) {
  return (uint32_t)lut[w & 0xFFFFu] | ((uint32_t)lut[w >> 16] << 16);
}

__device__ __forceinline__ uint4 lookup_vec(const uint16_t* lut, uint4 v) {
  return make_uint4(lookup_bf16x2(lut, v.x), lookup_bf16x2(lut, v.y),
                    lookup_bf16x2(lut, v.z), lookup_bf16x2(lut, v.w));
}

__device__ __forceinline__ float lookup_scalar(const uint16_t* lut,
                                               float v) {
  return __uint_as_float((uint32_t)lut[bf16_bits(v)] << 16);
}

__device__ __forceinline__ __nv_bfloat16 lookup_scalar(const uint16_t* lut,
                                                       __nv_bfloat16 v) {
  return __ushort_as_bfloat16(lut[__bfloat16_as_ushort(v)]);
}

// ------------------------------------------------------------- streaming

// 16-byte vector of T: float4 (4 lanes) or uint4 (8 bf16 lanes), and
// how many of them a thread of the computed form loads before its first
// exp. An f32 vector's exps stream best one a thread at this grid; bf16
// holds twice the lanes, and vexp's ~36 instructions a lane need four
// vectors a thread in flight to hide them (tools/vexp_forms.py).
template <typename T> struct Vec {
  using type = uint4;
  static constexpr int kLanes = 8;
  static constexpr int kUnroll = 4;
};
template <> struct Vec<float> {
  using type = float4;
  static constexpr int kLanes = 4;
  static constexpr int kUnroll = 1;
};

template <typename T>
__device__ __forceinline__ long long vector_count(const T* x, const T* y,
                                                  long long n) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  return aligned ? n / Vec<T>::kLanes : 0;
}

// This CTA's contiguous share [lo, hi) of the nvec vectors, equal for
// every CTA (so all of them end together) and a multiple of 32 vectors
// (so each warp's 512-byte access starts on a cache line).
__device__ __forceinline__ void cta_share(long long nvec, long long* lo,
                                          long long* hi) {
  const long long share = (nvec + 32LL * gridDim.x - 1) /
                          (32LL * gridDim.x) * 32;
  *lo = min(nvec, (long long)blockIdx.x * share);
  *hi = min(nvec, *lo + share);
}

// thread's vectors base + u * THREADS (u < UNROLL), those below hi
template <int THREADS, int UNROLL, typename V>
__device__ __forceinline__ void load_vecs(V (&v)[UNROLL], const V* xv,
                                          long long base, long long hi) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + (long long)u * THREADS;
    if (i < hi) v[u] = __ldcs(xv + i);
  }
}

template <typename T, int BACKEND>
__global__ void __launch_bounds__(kThreads)
vexp_stream_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  using V = typename Vec<T>::type;
  constexpr int kUnroll = Vec<T>::kUnroll;
  const long long nvec = vector_count(x, y, n);
  const V* xv = reinterpret_cast<const V*>(x);
  V* yv = reinterpret_cast<V*>(y);
  long long lo, hi;
  cta_share(nvec, &lo, &hi);
#pragma unroll 1
  for (long long base = lo + threadIdx.x; base < hi;
       base += kThreads * kUnroll) {
    V v[kUnroll];
    load_vecs<kThreads, kUnroll>(v, xv, base, hi);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < hi) __stcs(yv + i, exp_vec<BACKEND>(v[u]));
    }
  }
  for (long long i = nvec * Vec<T>::kLanes +
                     (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kThreads)
    y[i] = exp_scalar<BACKEND>(x[i]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_wait(uint32_t bar,
                                              uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kTableThreads, 1)
vexp_hw_table_kernel(const T* __restrict__ x, T* __restrict__ y,
                     long long n, const uint16_t* __restrict__ table) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TableSmem& s = *reinterpret_cast<TableSmem*>(smem_raw);
  const uint32_t bar = smem_addr(&s.bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    constexpr int kChunk = kTableBytes / kTableCopies;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(kTableBytes) : "memory");
    for (int c = 0; c < kTableCopies; ++c)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s.lut) + c * kChunk),
          "l"(reinterpret_cast<const char*>(table) + c * kChunk),
          "r"(kChunk), "r"(bar)
          : "memory");
  }
  using V = typename Vec<T>::type;
  const long long nvec = vector_count(x, y, n);
  const V* xv = reinterpret_cast<const V*>(x);
  V* yv = reinterpret_cast<V*>(y);
  long long lo, hi;
  cta_share(nvec, &lo, &hi);
  long long base = lo + threadIdx.x;
  V v[kTableUnroll];
  load_vecs<kTableThreads, kTableUnroll>(v, xv, base, hi);  // table lands
  mbarrier_wait(bar, 0);                         // every CTA waits
  const uint16_t* lut = s.lut;
#pragma unroll 1
  for (; base < hi; base += kTableThreads * kTableUnroll) {
#pragma unroll
    for (int u = 0; u < kTableUnroll; ++u) {
      const long long i = base + (long long)u * kTableThreads;
      if (i < hi) __stcs(yv + i, lookup_vec(lut, v[u]));
    }
    load_vecs<kTableThreads, kTableUnroll>(
        v, xv, base + kTableThreads * kTableUnroll, hi);
  }
  for (long long i = nvec * Vec<T>::kLanes +
                     (long long)blockIdx.x * kTableThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kTableThreads)
    y[i] = lookup_scalar(lut, x[i]);
}

// the BF16 hardware model on every bit pattern, 8 patterns a step
__global__ void __launch_bounds__(kThreads)
vexp_hw_table_build_kernel(uint4* __restrict__ table) {
#pragma unroll 1
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < kTableEntries / 8;
       i += gridDim.x * kThreads) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = i * 8 + 2 * j;
      w[j] = (uint32_t)vexp::vexp_hw_bits((uint16_t)b) |
             ((uint32_t)vexp::vexp_hw_bits((uint16_t)(b + 1)) << 16);
    }
    table[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ------------------------------------------------------------------ host

// CTAs for n elements: one per step of `unroll` vectors a thread (past
// the launch limit, cta_share gives each CTA more steps)
long long grid_for(long long n, int lanes, int threads, int unroll) {
  const long long per_cta = (long long)lanes * threads * unroll;
  const long long need = (n + per_cta - 1) / per_cta;
  return need < kMaxGrid ? need : kMaxGrid;
}

template <typename T, int BACKEND>
int launch_stream(const void* x, void* y, long long n, cudaStream_t s) {
  const long long blocks =
      grid_for(n, Vec<T>::kLanes, kThreads, Vec<T>::kUnroll);
  vexp_stream_kernel<T, BACKEND><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_table(const void* x, void* y, long long n, const void* table,
                 cudaStream_t s) {
  // the shared-memory limit, raised once per instance and device
  static bool raised[kMaxDevices] = {};
  const size_t smem = sizeof(TableSmem);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&vexp_hw_table_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const long long blocks =
      grid_for(n, Vec<T>::kLanes, kTableThreads, kTableUnroll);
  vexp_hw_table_kernel<T><<<(unsigned)blocks, kTableThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n,
      static_cast<const uint16_t*>(table));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). table: the 65,536
// vexp_hw results (vexp_hw_table_build), read only under vexp_hw.
extern "C" int vexp_launch(const void* x, void* y, long long n, int dtype,
                           int backend, const void* table, void* stream) {
  if (n <= 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == 0;
  switch (backend) {
    case vexp::kExact:
      return f32 ? launch_stream<float, vexp::kExact>(x, y, n, s)
                 : launch_stream<__nv_bfloat16, vexp::kExact>(x, y, n, s);
    case vexp::kVexp:
      return f32 ? launch_stream<float, vexp::kVexp>(x, y, n, s)
                 : launch_stream<__nv_bfloat16, vexp::kVexp>(x, y, n, s);
    case vexp::kVexpHw:
      if (table == nullptr) return (int)cudaErrorInvalidValue;
      return f32 ? launch_table<float>(x, y, n, table, s)
                 : launch_table<__nv_bfloat16>(x, y, n, table, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// table: 65,536 uint16, 16-byte aligned; entry b = vexp_hw_bits(b).
extern "C" int vexp_hw_table_build(void* table, void* stream) {
  vexp_hw_table_build_kernel<<<kTableEntries / 8 / kThreads, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(table));
  return (int)cudaGetLastError();
}
