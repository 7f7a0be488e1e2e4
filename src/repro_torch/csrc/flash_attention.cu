// FlashAttention-2 forward with the policy's exponential, ragged keys.
//
// Replaces: repro/kernels/flash_attention/kernel.py, flash_attention_bhsd
// (_fa_kernel). Same math: f32 dot products of (q * sm_scale) with k, the
// online (m, l, acc) update once per KV block of `block_k` keys, p masked
// after the exp (a masked lane would otherwise add vexp(0) = 1), output
// acc * 1/max(l, 1e-30) rounded to bf16. Adds per-row key lengths
// (`kv_len`) and per-row query offsets (`q_offset`: query i of row b sits
// at absolute position q_offset[b] + i, key j at j; causal keep is
// j <= q_offset[b] + i), so ragged serving prefill and suffix prefill
// against a shared-prefix history both run on this kernel.
//
// Bound on this card: bytes. At gpt2-small prefill (D = 64, 512 tokens,
// ragged rows) moving q, o and each row's live K/V once at 3.35 TB/s
// takes longer than the function's multiply-adds at the bf16 tensor-core
// rate (chip_smoke.py computes both). This first version keeps the
// reference's f32 dot products and runs them on the CUDA cores, not the
// tensor cores (a bf16 wgmma would round q * sm_scale to bf16 and leave
// the function the reference computes), so its own f32 datapath, not
// memory, holds it far above that bound.
// Design: one CTA per (batch, head, 64-query tile), 256 threads. The
// q tile (scaled, f32) stays in shared memory; per KV block, K arrives in
// 64-key f32 sub-tiles, every thread computes a 4 x 4 patch of scores
// into a shared (64 x block_k) score tile, four threads per row take the
// block's max, exp and sum, then V arrives in 64-key sub-tiles and each
// thread accumulates a 4 x (D/16) patch of p @ v in registers. Threads
// split a block internally; the (m, l, acc) update stays once per block,
// so the block partition, and with it the vexp result, is the
// reference's. Blocks are counted from key 0 whatever the query offset,
// as the scan counts them. KV blocks past the causal bound, past kv_len
// or below the window are skipped: for their rows they would be an exact
// no-op (alpha = exp(0) = 1, p = 0). The score tile needs dynamic shared memory
// above 48 KB (opted in per launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vexp.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kTK = 64;        // keys per shared-memory sub-tile
constexpr int kThreads = 256;  // 16 row groups x 16 key/column groups
constexpr float kNegInf = -1e30f;

struct Strides {               // element strides; the last dim is packed
  long long b, h, s;
};

__device__ __forceinline__ bool keep_key(int kp, int qp, int klen,
                                         int causal, int window) {
  return kp < klen && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, const int* __restrict__ kv_len,
              const int* __restrict__ q_offset, int H, int Hkv, int Sq,
              int Sk, Strides qs, Strides ks, Strides vs, Strides os,
              float sm_scale, int causal, int window, int block_k,
              int backend) {
  constexpr int DP = D + 1;              // padded row: no bank conflicts
  constexpr int NC = D / 16;             // output columns per thread
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int SS = block_k + 4;            // score row stride

  extern __shared__ float smem[];
  float* sQ = smem;                      // kBQ x DP
  float* sKV = sQ + kBQ * DP;            // kTK x DP (K, then V)
  float* sS = sKV + kTK * DP;            // kBQ x SS scores, then p
  float* sM = sS + kBQ * SS;
  float* sL = sM + kBQ;
  float* sA = sL + kBQ;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float val = 0.0f;
    if (q0 + r < Sq)
      val = __fmul_rn(__bfloat162float(qb[(q0 + r) * qs.s + d]), sm_scale);
    sQ[r * DP + d] = val;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.0f;
  }

  const int klen = kv_len != nullptr ? min(kv_len[b], Sk) : Sk;
  const int qoff = q_offset != nullptr ? q_offset[b] : 0;
  const int qa0 = qoff + q0;                      // absolute pos of row 0
  int kend = klen;                                // exclusive
  if (causal) kend = min(kend, qa0 + kBQ);
  const int kstart = window > 0 ? max(0, qa0 - window + 1) : 0;
  const int blk_first = kstart / block_k;
  const int blk_end = (kend + block_k - 1) / block_k;

  const int rg = tid / 16;     // rows rg*4 .. rg*4+3
  const int cg = tid % 16;     // keys / columns cg + 16*j
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  __syncthreads();

  for (int blk = blk_first; blk < blk_end; ++blk) {
    const int k0 = blk * block_k;
    const int bk = min(block_k, Sk - k0);

    // ---- scores s = (q * scale) . k for the whole block, masked
    for (int t0 = 0; t0 < bk; t0 += kTK) {
      for (int i = tid; i < kTK * D; i += kThreads) {
        const int c = i / D, d = i % D;
        float val = 0.0f;
        if (t0 + c < bk) val = __bfloat162float(kb[(k0 + t0 + c) * ks.s + d]);
        sKV[c * DP + d] = val;
      }
      __syncthreads();
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * DP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = sKV[(cg + 16 * j) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = t0 + cg + 16 * j;
          if (c < bk)
            sS[r * SS + c] = keep_key(k0 + c, qa0 + r, klen, causal, window)
                                 ? s[i][j] : kNegInf;
        }
      }
      __syncthreads();
    }

    // ---- row max, rescale factor, p = exp(s - m_new) masked, row sum
    {
      const int r = tid / 4, part = tid % 4;
      const int qp = qa0 + r;
      float* row = sS + r * SS;
      float mx = kNegInf;
      for (int c = part; c < bk; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = vexp::apply_exp(backend, __fsub_rn(m_prev, m_new));
      float sum = 0.0f;
      for (int c = part; c < bk; c += 4) {
        const float p = keep_key(k0 + c, qp, klen, causal, window)
            ? vexp::apply_exp(backend, __fsub_rn(row[c], m_new)) : 0.0f;
        row[c] = p;
        sum = __fadd_rn(sum, p);
      }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
      if (part == 0) {
        sL[r] = __fadd_rn(__fmul_rn(sL[r], alpha), sum);
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + p @ v
    float pv[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) pv[i][j] = 0.0f;
    for (int t0 = 0; t0 < bk; t0 += kTK) {
      for (int i = tid; i < kTK * D; i += kThreads) {
        const int c = i / D, d = i % D;
        float val = 0.0f;
        if (t0 + c < bk) val = __bfloat162float(vb[(k0 + t0 + c) * vs.s + d]);
        sKV[c * DP + d] = val;
      }
      __syncthreads();
      const int nk = min(kTK, bk - t0);
      for (int c = 0; c < nk; ++c) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = sS[(rg * 4 + i) * SS + t0 + c];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float vv = sKV[c * DP + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i][j] = fmaf(p[i], vv, pv[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < NC; ++j)
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], alpha), pv[i][j]);
    }
    // the next block's score pass rewrites sS/sA only after this
    // block's last __syncthreads above
  }

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (q0 + r >= Sq) continue;
    const float inv = 1.0f / fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ob[(q0 + r) * os.s + cg + 16 * j] =
          __float2bfloat16_rn(__fmul_rn(acc[i][j], inv));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* kv_len, const void* q_offset, int B, int H, int Hkv,
           int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
           float sm_scale, int causal, int window, int block_k, int backend,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBQ * (D + 1) + (size_t)kTK * (D + 1) +
       (size_t)kBQ * (block_k + 4) + 3 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  fa_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_offset), H, Hkv, Sq, Sk, qs, ks, vs, os,
      sm_scale, causal, window, block_k, backend);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Hkv,Sk,D), o (B,H,Sq,D): bf16, any strides with the
// last dim packed. kv_len: (B,) int32 or null (every key real). q_offset:
// (B,) int32 or null (all 0). window <= 0 means no window. Returns
// cudaGetLastError() after the launch.
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      const void* kv_len, const void* q_offset, int B,
                      int H, int Hkv, int Sq, int Sk, int D,
                      long long qsb, long long qsh, long long qss,
                      long long ksb, long long ksh, long long kss,
                      long long vsb, long long vsh, long long vss,
                      long long osb, long long osh, long long oss,
                      float sm_scale, int causal, int window,
                      int block_k, int backend, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, kv_len, q_offset, B, H, Hkv, Sq, Sk, qs,
                        ks, vs, os, sm_scale, causal, window, block_k,
                        backend, s);
    case 64:
      return launch<64>(q, k, v, o, kv_len, q_offset, B, H, Hkv, Sq, Sk, qs,
                        ks, vs, os, sm_scale, causal, window, block_k,
                        backend, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory bytes a launch needs (the wrapper checks it
// against the card's per-block limit before launching).
extern "C" long long fa_smem_bytes(int D, int block_k) {
  return (long long)sizeof(float) *
         ((long long)kBQ * (D + 1) + (long long)kTK * (D + 1) +
          (long long)kBQ * (block_k + 4) + 3LL * kBQ);
}
