// Paged flash-decode: per-row block tables over a pool of KV pages.
//
// Replaces: repro/kernels/decode_attention/kernel.py,
// decode_attention_kernel_paged (_paged_kernel via _paged_call,
// partial=False). The KV cache is a pool of fixed-size pages, "bshd"
// (N, page, Hkv, d) or "bhsd" (N, Hkv, page, d), and row b's logical page
// si lives at pool page block_tab[b, si]. Same math and casts as the
// reference: q is scaled in f32 and rounded to bf16 before the score
// dot; scores accumulate in f32; the online (m, l, acc) update runs once
// per PAGE (the Pallas grid steps one page at a time; under vexp the
// partition is part of the result, so this kernel must not update per
// block_s as the contiguous sweep does); p is masked after the exp, summed
// in f32 for l, and rounded to bf16 before the p @ v dot, which
// accumulates in f32. Output acc * 1/max(l, 1e-30) in bf16.
//
// Bound on this card: bytes. Each live key is read once (its K and V
// rows, 4*d bytes) for ~4*G*d flops, about one flop per byte at G = 1.
// Design: one CTA per (batch row, KV head), 256 threads, holding the G
// query rows of that head. The CTA loads its own table entries and walks
// the row's logical pages from the first one the window keeps to the
// last one below cache_len; pages at or past cache_len (table entries
// that point at the scratch page 0) are never read. Per page: a group of
// TPK threads shares each key, each thread reading d/TPK of the K row in
// 16-byte loads, and the group sums its partial dots with shuffles; one
// warp per query row takes max, exp and sum; then the threads split into
// (256/d) key groups x d columns for p @ v, summed in a fixed order
// through shared memory. With batch 8 and 12 heads this is 96 CTAs on
// 132 SMs, each sweeping its row's pages serially; TMA page gathers and
// splitting a row's pages across CTAs are later work.
//
// Also replaces decode_attention_kernel_paged_partial and
// decode_attention_kernel_paged_packed (_paged_kernel with partial=True,
// and packed=True): the same walk over one shard of a sequence-sharded
// pool. The pool is the shard's own (local page ids, its page 0 the
// scratch page) and block_tab its (B, nS) slice of the table columns,
// whose logical page 0 sits at global position seq_offset; cache_len
// stays global, so local token t is kept when
// cache_len - window <= t + seq_offset < cache_len. Instead of the
// normalized output the walk writes its raw f32 statistics: m and l
// (B,Hkv,G,1) and acc (B,Hkv,G,d) (partial), or one (B,Hkv,G,d+2) tile
// laid out [acc | m | l] (packed). A row with no key on this shard walks
// no page and writes the merge identity (KERNEL_NEG_INF = -1e30, 0, 0),
// never -inf. Bound and design as above; the statistics written are
// (d+2)*4 bytes per query row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vexp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;   // core/softmax.py KERNEL_NEG_INF

// what the walk writes (the reference's partial / packed flags)
enum Mode { kNormalized = 0, kPartial = 1, kPacked = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kpool,
                    const __nv_bfloat16* __restrict__ vpool,
                    void* __restrict__ o, float* __restrict__ om,
                    float* __restrict__ ol,
                    const int* __restrict__ block_tab,
                    const int* __restrict__ cache_len, int Hkv, int G,
                    int page, int nS, long long psn, long long psh,
                    long long pst, float sm_scale, int window, int tpk,
                    int seq_offset, int backend) {
  constexpr int KG = kThreads / D;        // key groups in the p @ v pass
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  extern __shared__ float smem[];
  float* sQ = smem;                       // G x D, bf16-rounded q * scale
  float* sS = sQ + G * D;                 // G x page scores, then p
  float* sP = sS + G * page;              // G x D x KG partial p @ v
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

  // this shard's kept keys, in local token positions: [lo, len)
  const int len_g = cache_len[b];
  const int len = min(max(len_g - seq_offset, 0), nS * page);
  const int lo = window > 0
      ? min(max(len_g - window - seq_offset, 0), nS * page) : 0;
  const int pg_first = lo / page;
  const int pg_end = (len + page - 1) / page;
  const int* trow = block_tab + (long long)b * nS;

  const int d = tid % D, kg = tid / D;
  const int sub = tid % tpk;              // this thread's slice of a K row
  const int per_pass = kThreads / tpk;    // keys scored per pass
  const int v8s = D / 8 / tpk;            // 16-byte loads per thread
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.0f;
  __syncthreads();

  for (int si = pg_first; si < pg_end; ++si) {
    const long long phys = trow[si];
    const __nv_bfloat16* kb = kpool + phys * psn + h * psh;
    const __nv_bfloat16* vb = vpool + phys * psn + h * psh;
    const int k0 = si * page;

    // ---- scores: tpk threads per key, partial dots summed by shuffles
    for (int base = 0; base < page; base += per_pass) {
      const int c = base + tid / tpk;
      const bool valid = c < page;
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.0f;
      if (valid) {
        const uint4* row = reinterpret_cast<const uint4*>(kb + c * pst);
        for (int j = 0; j < v8s; ++j) {
          const int v8 = sub * v8s + j;
          const uint4 raw = row[v8];
          const __nv_bfloat16* e =
              reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float kv = __bfloat162float(e[t]);
#pragma unroll
            for (int g = 0; g < kMaxG; ++g)
              if (g < G) s[g] = fmaf(sQ[g * D + v8 * 8 + t], kv, s[g]);
          }
        }
      }
      for (int off = tpk / 2; off > 0; off /= 2) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          s[g] = __fadd_rn(s[g], __shfl_xor_sync(0xffffffffu, s[g], off));
      }
      if (valid && sub == 0) {
        const int kp = k0 + c;
        const bool keep = kp < len && kp >= lo;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) sS[g * page + c] = keep ? s[g] : kNegInf;
      }
    }
    __syncthreads();

    // ---- one warp per query row: max, exp, sum; p stored bf16-rounded
    for (int g = warp; g < G; g += kThreads / 32) {
      float* row = sS + g * page;
      float mx = kNegInf;
      for (int c = lane; c < page; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = vexp::apply_exp(backend, __fsub_rn(m_prev, m_new));
      float sum = 0.0f;
      for (int c = lane; c < page; c += 32) {
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
    for (int c = kg; c < page; c += KG) {
      const float vv = __bfloat162float(vb[c * pst + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) pv[g] = fmaf(sS[g * page + c], vv, pv[g]);
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
          for (int j = 0; j < KG; ++j)
            t = __fadd_rn(t, sP[(g * D + d) * KG + j]);
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
  // raw statistics of this shard; a row that walked no page still holds
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
int launch(const void* q, const void* kp, const void* vp, void* o, void* om,
           void* ol, const void* tab, const void* cache_len, int B, int Hkv,
           int G, int page, int nS, long long psn, long long psh,
           long long pst, float sm_scale, int window, int seq_offset,
           int backend, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)G * D + (size_t)G * page + (size_t)G * D * (kThreads / D) +
       3 * (size_t)G);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<D, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // threads per key in the score pass: a power of two, at most one
  // 16-byte load each, and no more than the page needs to fill the CTA
  int tpk = 1;
  while (tpk * 2 <= D / 8 && tpk * 2 * page <= kThreads) tpk *= 2;
  dim3 grid(Hkv, B);
  paged_decode_kernel<D, MODE><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), o, static_cast<float*>(om),
      static_cast<float*>(ol), static_cast<const int*>(tab),
      static_cast<const int*>(cache_len), Hkv, G, page, nS, psn, psh, pst,
      sm_scale, window, tpk, seq_offset, backend);
  return (int)cudaGetLastError();
}

template <int MODE>
int run(const void* q, const void* kp, const void* vp, void* o, void* om,
        void* ol, const void* tab, const void* cache_len, int B, int Hkv,
        int G, int D, int page, int nS, long long psn, long long psh,
        long long pst, float sm_scale, int window, int seq_offset,
        int backend, void* stream) {
  if (B == 0) return 0;
  if (G < 1 || G > kMaxG || page < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32, MODE>(q, kp, vp, o, om, ol, tab, cache_len, B, Hkv,
                              G, page, nS, psn, psh, pst, sm_scale, window,
                              seq_offset, backend, s);
    case 64:
      return launch<64, MODE>(q, kp, vp, o, om, ol, tab, cache_len, B, Hkv,
                              G, page, nS, psn, psh, pst, sm_scale, window,
                              seq_offset, backend, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All three entries take the same arguments. q: (B,Hkv,G,D) packed bf16;
// K/V pools bf16, page p / head h / token t of a pool at
// base + p*psn + h*psh + t*pst (+ d, packed), rows 16-byte aligned;
// block_tab: (B,nS) int32 packed, pool page ids, logical page 0 at global
// position seq_offset; cache_len: (B,) int32 global lengths. window <= 0
// means no window. G <= 8. Each returns cudaGetLastError() after its
// launch.
//
// paged_decode_fwd: o (B,Hkv,G,D) bf16, the normalized output (om, ol
// unused).
extern "C" int paged_decode_fwd(const void* q, const void* kp,
                                const void* vp, void* o, void* om, void* ol,
                                const void* tab, const void* cache_len,
                                int B, int Hkv, int G, int D, int page,
                                int nS, long long psn, long long psh,
                                long long pst, float sm_scale, int window,
                                int seq_offset, int backend, void* stream) {
  return run<kNormalized>(q, kp, vp, o, om, ol, tab, cache_len, B, Hkv, G, D,
                          page, nS, psn, psh, pst, sm_scale, window,
                          seq_offset, backend, stream);
}

// paged_decode_partial_fwd: o = acc (B,Hkv,G,D), om = m and ol = l
// (B,Hkv,G,1), all f32.
extern "C" int paged_decode_partial_fwd(
    const void* q, const void* kp, const void* vp, void* o, void* om,
    void* ol, const void* tab, const void* cache_len, int B, int Hkv, int G,
    int D, int page, int nS, long long psn, long long psh, long long pst,
    float sm_scale, int window, int seq_offset, int backend, void* stream) {
  return run<kPartial>(q, kp, vp, o, om, ol, tab, cache_len, B, Hkv, G, D,
                       page, nS, psn, psh, pst, sm_scale, window, seq_offset,
                       backend, stream);
}

// paged_decode_packed_fwd: o = the (B,Hkv,G,D+2) f32 tile [acc | m | l]
// (om, ol unused).
extern "C" int paged_decode_packed_fwd(
    const void* q, const void* kp, const void* vp, void* o, void* om,
    void* ol, const void* tab, const void* cache_len, int B, int Hkv, int G,
    int D, int page, int nS, long long psn, long long psh, long long pst,
    float sm_scale, int window, int seq_offset, int backend, void* stream) {
  return run<kPacked>(q, kp, vp, o, om, ol, tab, cache_len, B, Hkv, G, D,
                      page, nS, psn, psh, pst, sm_scale, window, seq_offset,
                      backend, stream);
}
