// Flash-decode over a contiguous KV cache, per-row lengths, optional window.
//
// Replaces: repro/kernels/decode_attention/kernel.py,
// decode_attention_kernel (_decode_kernel with partial=False). Same math
// and casts: q is scaled in f32 and rounded to the cache dtype (bf16)
// before the score dot; scores accumulate in f32; the online (m, l, acc)
// update runs once per KV block of `block_s` keys; p is masked after the
// exp, summed in f32 for l, and rounded to bf16 before the p @ v dot,
// which accumulates in f32. Output acc * 1/max(l, 1e-30) in bf16. One
// kernel serves both cache layouts: the caller passes the cache strides
// ("bshd" (B,S,Hkv,d) and "bhsd" (B,Hkv,S,d) differ only in them).
//
// Bound on this card: bytes. Each live key is read once (K and V rows,
// 4*d bytes) for ~4*G*d flops, about one flop per byte at G = 1.
// Design: one CTA per (batch row, KV head), 256 threads, holding the G
// query rows of that head. Per block: each thread owns block_s/256 keys
// and loads a whole K row with 16-byte vector loads, writing G scores to
// shared memory; one warp per query row takes max, exp and sum; then the
// threads split into (256/d) key groups x d columns, each column thread
// reading V rows coalesced and accumulating p @ v, and the key groups are
// summed through shared memory. Blocks past the row's length or below its
// window are skipped (an exact no-op for that row). With batch 8 and 12
// heads this is 96 CTAs on 132 SMs, each sweeping its row serially;
// splitting the sequence across CTAs is later work.
//
// Also replaces decode_attention_kernel_partial and
// decode_attention_kernel_packed (_decode_kernel with partial=True, and
// packed=True): the same sweep over one shard of a sequence-sharded
// cache. The cache pointers address the shard's local slice of S rows,
// whose first row sits at global position seq_offset; cache_len stays
// global, so a key at local row r is kept when
// cache_len - window <= r + seq_offset < cache_len. Blocks count from
// the slice's local row 0, as the Pallas grid does. Instead of the
// normalized output the sweep writes its raw f32 statistics: m and l
// (B,Hkv,G,1) and acc (B,Hkv,G,d) (partial), or one (B,Hkv,G,d+2) tile
// laid out [acc | m | l] (packed; no lane padding, unlike the
// reference's d_pad + 2). A row with no key on this shard sweeps no
// block and writes the merge identity (KERNEL_NEG_INF = -1e30, 0, 0):
// every output element is written, and never -inf (vexp of -inf - -inf
// is NaN). Bound and design as above; the statistics written are
// (d+2)*4 bytes per query row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vexp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;   // core/softmax.py KERNEL_NEG_INF

// what the sweep writes (the reference's partial / packed flags)
enum Mode { kNormalized = 0, kPartial = 1, kPacked = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ kc,
              const __nv_bfloat16* __restrict__ vc,
              void* __restrict__ o, float* __restrict__ om,
              float* __restrict__ ol,
              const int* __restrict__ cache_len, int Hkv, int G, int S,
              long long csb, long long csh, long long css, float sm_scale,
              int window, int block_s, int seq_offset, int backend) {
  constexpr int KG = kThreads / D;        // key groups in the p @ v pass
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  extern __shared__ float smem[];
  float* sQ = smem;                       // G x D, bf16-rounded q * scale
  float* sS = sQ + G * D;                 // G x block_s scores, then p
  float* sP = sS + G * block_s;           // G x D x KG partial p @ v
  float* sM = sP + G * D * KG;
  float* sL = sM + G;
  float* sA = sL + G;

  const long long qoff = ((long long)b * Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    sQ[i] = bf16_round(__fmul_rn(__bfloat162float(q[qoff + i]), sm_scale));
  for (int g = tid; g < G; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.0f;
  }

  // this slice's kept keys, in local rows: [lo, len)
  const int len_g = cache_len[b];
  const int len = min(max(len_g - seq_offset, 0), S);
  const int lo = window > 0 ? min(max(len_g - window - seq_offset, 0), S) : 0;
  const int blk_first = lo / block_s;
  const int blk_end = (len + block_s - 1) / block_s;
  const __nv_bfloat16* kb = kc + b * csb + h * csh;
  const __nv_bfloat16* vb = vc + b * csb + h * csh;

  const int d = tid % D, kg = tid / D;
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.0f;
  __syncthreads();

  for (int blk = blk_first; blk < blk_end; ++blk) {
    const int k0 = blk * block_s;
    const int bs = min(block_s, S - k0);

    // ---- scores: one thread per key, whole K row in 16-byte loads
    for (int c = tid; c < bs; c += kThreads) {
      const int kp = k0 + c;
      const uint4* row = reinterpret_cast<const uint4*>(kb + kp * css);
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.0f;
#pragma unroll
      for (int v8 = 0; v8 < D / 8; ++v8) {
        const uint4 raw = row[v8];
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float kv = __bfloat162float(e[t]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) s[g] = fmaf(sQ[g * D + v8 * 8 + t], kv, s[g]);
        }
      }
      const bool keep = kp < len && kp >= lo;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) sS[g * block_s + c] = keep ? s[g] : kNegInf;
    }
    __syncthreads();

    // ---- one warp per query row: max, exp, sum; p stored bf16-rounded
    for (int g = warp; g < G; g += kThreads / 32) {
      float* row = sS + g * block_s;
      float mx = kNegInf;
      for (int c = lane; c < bs; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = vexp::apply_exp(backend, __fsub_rn(m_prev, m_new));
      float sum = 0.0f;
      for (int c = lane; c < bs; c += 32) {
        const int kp = k0 + c;
        const float p = (kp < len && kp >= lo)
            ? vexp::apply_exp(backend, __fsub_rn(row[c], m_new)) : 0.0f;
        sum = __fadd_rn(sum, p);
        row[c] = bf16_round(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      if (lane == 0) {
        sL[g] = __fadd_rn(__fmul_rn(sL[g], alpha), sum);
        sM[g] = m_new;
        sA[g] = alpha;
      }
    }
    __syncthreads();

    // ---- p @ v: KG key groups x D columns, then a fixed-order group sum
    float pv[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) pv[g] = 0.0f;
    for (int c = kg; c < bs; c += KG) {
      const float vv = __bfloat162float(vb[(k0 + c) * css + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) pv[g] = fmaf(sS[g * block_s + c], vv, pv[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) sP[(g * D + d) * KG + kg] = pv[g];
    __syncthreads();
    if (kg == 0) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float t = 0.0f;
          for (int j = 0; j < KG; ++j) t = __fadd_rn(t, sP[(g * D + d) * KG + j]);
          acc[g] = __fadd_rn(__fmul_rn(acc[g], sA[g]), t);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (MODE == kNormalized) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
    if (kg == 0) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float inv = 1.0f / fmaxf(sL[g], 1e-30f);
          out[qoff + g * D + d] =
              __float2bfloat16_rn(__fmul_rn(acc[g], inv));
        }
      }
    }
    return;
  }
  // raw statistics of this slice; a row that swept nothing still holds
  // the identity (kNegInf, 0, 0) from the initialisation
  constexpr int W = MODE == kPacked ? D + 2 : D;   // row width of acc
  float* out = static_cast<float*>(o);
  const long long row = (long long)b * Hkv + h;     // (b, h) of (B, Hkv)
  if (kg == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) out[(row * G + g) * W + d] = acc[g];
  }
  if (tid < G) {
    if constexpr (MODE == kPacked) {
      out[(row * G + tid) * W + D] = sM[tid];
      out[(row * G + tid) * W + D + 1] = sL[tid];
    } else {
      om[row * G + tid] = sM[tid];
      ol[row * G + tid] = sL[tid];
    }
  }
}

template <int D, int MODE>
int launch(const void* q, const void* kc, const void* vc, void* o, void* om,
           void* ol, const void* cache_len, int B, int Hkv, int G, int S,
           long long csb, long long csh, long long css, float sm_scale,
           int window, int block_s, int seq_offset, int backend,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)G * D + (size_t)G * block_s + (size_t)G * D * (kThreads / D) +
       3 * (size_t)G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  decode_kernel<D, MODE><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), o, static_cast<float*>(om),
      static_cast<float*>(ol), static_cast<const int*>(cache_len), Hkv, G, S,
      csb, csh, css, sm_scale, window, block_s, seq_offset, backend);
  return (int)cudaGetLastError();
}

template <int MODE>
int run(const void* q, const void* kc, const void* vc, void* o, void* om,
        void* ol, const void* cache_len, int B, int Hkv, int G, int S, int D,
        long long csb, long long csh, long long css, float sm_scale,
        int window, int block_s, int seq_offset, int backend, void* stream) {
  if (B == 0) return 0;
  if (G < 1 || G > kMaxG || block_s < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32, MODE>(q, kc, vc, o, om, ol, cache_len, B, Hkv, G, S,
                              csb, csh, css, sm_scale, window, block_s,
                              seq_offset, backend, s);
    case 64:
      return launch<64, MODE>(q, kc, vc, o, om, ol, cache_len, B, Hkv, G, S,
                              csb, csh, css, sm_scale, window, block_s,
                              seq_offset, backend, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All three entries take the same arguments. q: (B,Hkv,G,D) packed bf16;
// k/v cache bf16 addressed as base + b*csb + h*csh + s*css (+ d, packed),
// rows 16-byte aligned, S rows from global position seq_offset on;
// cache_len: (B,) int32 global lengths. window <= 0 means no window.
// G <= 8. Each returns cudaGetLastError() after its launch.
//
// decode_fwd: o (B,Hkv,G,D) bf16, the normalized output (om, ol unused).
extern "C" int decode_fwd(const void* q, const void* kc, const void* vc,
                          void* o, void* om, void* ol, const void* cache_len,
                          int B, int Hkv, int G, int S, int D, long long csb,
                          long long csh, long long css, float sm_scale,
                          int window, int block_s, int seq_offset,
                          int backend, void* stream) {
  return run<kNormalized>(q, kc, vc, o, om, ol, cache_len, B, Hkv, G, S, D,
                          csb, csh, css, sm_scale, window, block_s,
                          seq_offset, backend, stream);
}

// decode_partial_fwd: o = acc (B,Hkv,G,D), om = m and ol = l (B,Hkv,G,1),
// all f32.
extern "C" int decode_partial_fwd(const void* q, const void* kc,
                                  const void* vc, void* o, void* om, void* ol,
                                  const void* cache_len, int B, int Hkv,
                                  int G, int S, int D, long long csb,
                                  long long csh, long long css,
                                  float sm_scale, int window, int block_s,
                                  int seq_offset, int backend, void* stream) {
  return run<kPartial>(q, kc, vc, o, om, ol, cache_len, B, Hkv, G, S, D, csb,
                       csh, css, sm_scale, window, block_s, seq_offset,
                       backend, stream);
}

// decode_packed_fwd: o = the (B,Hkv,G,D+2) f32 tile [acc | m | l] (om, ol
// unused).
extern "C" int decode_packed_fwd(const void* q, const void* kc,
                                 const void* vc, void* o, void* om, void* ol,
                                 const void* cache_len, int B, int Hkv, int G,
                                 int S, int D, long long csb, long long csh,
                                 long long css, float sm_scale, int window,
                                 int block_s, int seq_offset, int backend,
                                 void* stream) {
  return run<kPacked>(q, kc, vc, o, om, ol, cache_len, B, Hkv, G, S, D, csb,
                      csh, css, sm_scale, window, block_s, seq_offset,
                      backend, stream);
}
