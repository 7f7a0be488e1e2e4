// The sequence-split flash-decode sweep: one body for the contiguous
// cache (decode_attention.cu) and the paged pool
// (decode_attention_paged.cu), each with its three modes as epilogues.
//
// A row (batch row b, KV head h) holds G query rows and the slice's keys
// [0, S). Its online (m, l, acc) update runs once per update block of
// `block` keys counted from the slice's row 0 (block_s, or the page). A
// TILE is at most kTile = 64 keys of one update block: the block's keys
// from its start in steps of 64, so a tile never crosses a block (or a
// page). Two kernels run one after the other on the caller's stream, the
// second holding stages 2 and 3:
//
//   1. split_scores, one CTA per (tile, h, b), one thread per key: the
//      tile's kept K rows are copied to shared memory with 16-byte
//      cp.async, each score is q * sm_scale rounded to bf16 then an f32
//      FMA chain over d from 0, keys outside [lo, len) read -1e30; the
//      scores and the tile's max go to scratch. A tile with no kept key
//      loads nothing and writes max = -1e30.
//   2. split_pv, same grid: m_j = max(-1e30, the maxes of every tile of
//      update blocks 0..j), j this tile's block, which is exactly the
//      plain sweep's running max after block j (max is exact in any
//      order). p = exp(s - m_j), 0 outside [lo, len); its f32 sum is the
//      tile's l, and p rounded to bf16 times the tile's V rows (copied to
//      shared memory with cp.async) summed in f32 is the tile's p @ v.
//      The tile's CTA also writes its block's alpha_j = exp(m_{j-1} - m_j)
//      (m_{-1} = -1e30; m_{j-1} from the tile maxes of blocks 0..j-1).
//      Each CTA then takes a ticket for its row (a counter that stage 1
//      zeroed in this call, so no memset); the CTA that takes the row's
//      last ticket runs stage 3.
//   3. combine_row: for each update block j in order, the block's tiles
//      summed in tile order, then l = l * alpha_j + l_block and
//      acc = acc * alpha_j + pv_block, rounded step by step as the plain
//      sweep chains them; then the mode's epilogue.
//
// split_pv is a programmatic dependent launch: its CTAs start copying
// their V rows while split_scores drains, and wait for it
// (griddepcontrol.wait) before reading its output.
//
// Head dim 256 with G = 16 (recurrentgemma's MQA; normalized mode only):
// stage 1 takes dynamic shared memory (50 KB, above the 48 KB static
// limit) and reads each key's row from shared memory for every query row
// instead of holding it in registers; stage 2 is its own kernel,
// split_pv_chain, which chains each update block's p @ v and l over the
// block's keys in order in one CTA, the order in which the plain sweep's
// products sum on the card, so the kernel matches its plain version bit
// for bit there. The dense heads (D 32, 64; G <= 8) keep their static
// arrays and split_pv as they were.
//
// Why the running max per update block, and not one max per tile merged
// at the end (the usual split-KV merge): under vexp and vexp_hw,
// exp(a) * exp(b) != exp(a + b), so folding per-tile statistics with
// exp(m_t - m) computes another function. Here every exp argument is
// bitwise the plain sweep's (s - m_j and m_{j-1} - m_j); only the order
// of the f32 sums inside an update block changes.
//
// Scratch, one flat f32 buffer per call from the caller (uninitialised;
// every element read is written first in the same call), rows
// r = (b * Hkv + h) * G + g, R = B * Hkv * G, nT tiles per row:
// scores R * nT * kTile, tile maxes R * nT, tile l R * nT, the tile's
// block alpha R * nT, tile p @ v R * nT * D, then B * Hkv ticket counters.
// (At D = 256 a block's l and p @ v sit in its first live tile's slots and
// the block's other tiles hold zeros.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vexp.cuh"

namespace split {

constexpr int kTile = 64;             // keys per tile, one thread each
constexpr int kPvThreads = 128;
constexpr float kNegInf = -1e30f;     // core/softmax.py KERNEL_NEG_INF

// what the sweep writes (the reference's partial / packed flags)
enum Mode { kNormalized = 0, kPartial = 1, kPacked = 2 };

struct Args {
  const __nv_bfloat16* q;   // (B, Hkv, G, D)
  const __nv_bfloat16* k;   // cache or pool
  const __nv_bfloat16* v;
  void* o;
  float* om;
  float* ol;
  const int* cache_len;     // (B,) global lengths
  const int* tab;           // paged: (B, nS) pool page ids
  float* scores;            // scratch, carved by scratch_floats' layout
  float* tmax;
  float* tl;
  float* ta;                // each tile's block alpha_j
  float* tpv;
  unsigned* tickets;        // (B, Hkv) stage-2 CTAs done per row
  int B, Hkv, G, S;         // S: keys in the slice (paged: nS * page)
  int nS;                   // paged: table columns
  int block;                // update block, >= 1 (the page when paged)
  int tpb;                  // tiles per update block
  int nT;                   // tiles per row
  long long sb, sh, ss;     // strides of a batch row (pool page), head, key
  float sm_scale;
  int window, seq_offset, backend;
};

// Query rows per KV head an instantiation takes: 8 at the dense heads
// (D 32, 64), 16 at D 256 (recurrentgemma's 16 query heads on one KV
// head). Shared memory is sized by it, so the small heads keep theirs.
template <int D>
__host__ __device__ constexpr int max_g() {
  return D >= 256 ? 16 : 8;
}

// Whether stage 1's shared memory is dynamic: only where it passes the
// 48 KB static limit (D = 256); the dense heads keep their static
// arrays.
template <int D>
__host__ __device__ constexpr bool dyn_smem() {
  return D >= 256;
}

// Stage 1's shared memory, in bytes.
template <int D>
__host__ __device__ constexpr size_t scores_smem() {
  return (size_t)max_g<D>() * D * sizeof(float) +             // sQ
         (size_t)kTile * (D + 8) * sizeof(__nv_bfloat16) +    // sK
         (size_t)(kTile / 32) * max_g<D>() * sizeof(float);   // sMax
}

// Whether stage 2 chains each update block's p @ v and l over the
// block's keys in order (split_pv_chain, D = 256) instead of summing
// per-tile partials (split_pv).
template <int D>
__host__ __device__ constexpr bool block_chain() {
  return D >= 256;
}

// Floats of scratch a call needs; the wrappers compute the same.
inline long long scratch_floats(int B, int Hkv, int G, int D, int nT) {
  return (long long)B * Hkv * (G * nT * (kTile + 3 + D) + 1);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// this row's kept keys, in slice rows: [lo, len)
__device__ __forceinline__ void kept_range(const Args& a, int b, int& lo,
                                           int& len) {
  const int len_g = a.cache_len[b];
  len = min(max(len_g - a.seq_offset, 0), a.S);
  lo = a.window > 0 ? min(max(len_g - a.window - a.seq_offset, 0), a.S)
                    : 0;
}

// tile t: keys [k0, kend) of update block blk; the kept ones [c0, c1)
// (empty when c0 >= c1)
struct Tile {
  int blk, k0, kend, c0, c1;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int t, int lo,
                                        int len) {
  Tile x;
  x.blk = t / a.tpb;
  const int b0 = x.blk * a.block;
  x.k0 = b0 + (t % a.tpb) * kTile;
  x.kend = min(min(x.k0 + kTile, b0 + a.block), a.S);
  x.c0 = max(x.k0, lo);
  x.c1 = min(x.kend, len);
  return x;
}

// the pool page of tile t's update block (paged; read before the row's
// length is known, so it never waits on it), else 0
template <bool PAGED>
__device__ __forceinline__ long long page_of(const Args& a, int b, int t) {
  if constexpr (PAGED) {
    const int si = t / a.tpb;
    if (si < a.nS) return a.tab[(long long)b * a.nS + si];
  }
  return 0;
}

// kept rows [c0, c1) of a tile -> shared rows (c - k0) of `pitch` bf16;
// rows of one tile sit ss apart (a tile never crosses a page)
template <int D, bool PAGED, int THREADS>
__device__ __forceinline__ void load_rows(const Args& a,
                                          const __nv_bfloat16* base, int b,
                                          int h, long long phys,
                                          const Tile& x, __nv_bfloat16* dst,
                                          int pitch) {
  constexpr int CH = D / 8;               // 16-byte chunks per row
  const __nv_bfloat16* src =
      PAGED ? base + phys * a.sb + h * a.sh +
                  (long long)(x.c0 - x.blk * a.block) * a.ss
            : base + (long long)b * a.sb + h * a.sh + (long long)x.c0 * a.ss;
  __nv_bfloat16* out = dst + (x.c0 - x.k0) * pitch;
  const int n = (x.c1 - x.c0) * CH;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / CH, ch = i % CH;
    cp_async16(out + r * pitch + ch * 8, src + r * a.ss + ch * 8);
  }
}

// ---- stage 1: scores and the tile's max
template <int D, bool PAGED>
__global__ void __launch_bounds__(kTile) split_scores(Args a) {
  constexpr int PITCH = D + 8;            // 16 bytes of padding per row
  constexpr int kMaxG = max_g<D>();
  float* sQ;                     // [kMaxG][D]
  __nv_bfloat16* sK;             // [kTile][PITCH]
  float* sMax;                   // [kTile / 32][kMaxG]
  if constexpr (dyn_smem<D>()) {
    extern __shared__ __align__(16) unsigned char dsmem[];
    sQ = reinterpret_cast<float*>(dsmem);
    sK = reinterpret_cast<__nv_bfloat16*>(sQ + kMaxG * D);
    sMax = reinterpret_cast<float*>(sK + kTile * PITCH);
  } else {
    __shared__ float q_s[kMaxG * D];
    __shared__ __align__(16) __nv_bfloat16 k_s[kTile * PITCH];
    __shared__ float max_s[kTile / 32 * kMaxG];
    sQ = q_s;
    sK = k_s;
    sMax = max_s;
  }
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = a.G;
  const long long row0 = ((long long)b * a.Hkv + h) * G;
  // stage 2 may launch now: it waits for this grid before reading its
  // output (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;");
  const long long phys = page_of<PAGED>(a, b, t);
  int lo, len;
  kept_range(a, b, lo, len);
  const Tile x = tile_of(a, t, lo, len);
  if (t == 0 && tid == 0) a.tickets[(long long)b * a.Hkv + h] = 0u;
  if (x.c0 >= x.c1) {
    if (tid < G) a.tmax[(row0 + tid) * a.nT + t] = kNegInf;
    return;
  }
  load_rows<D, PAGED, kTile>(a, a.k, b, h, phys, x, sK, PITCH);
  for (int i = tid; i < G * D; i += kTile)
    sQ[i] = bf16_round(
        __fmul_rn(__bfloat162float(a.q[row0 * D + i]), a.sm_scale));
  cp_async_wait_all();
  __syncthreads();

  // the G query rows take their turns on the key's K row (a loop over the
  // runtime G, so G = 1 issues no idle work). Up to D = 64 the row stays
  // in registers; a D = 256 row (128 registers) is read from shared
  // memory each turn, the padded pitch keeping the reads conflict-free.
  constexpr bool kRegK = D <= 64;
  const int kp = x.k0 + tid;
  const bool keep = kp >= x.c0 && kp < x.c1;
  const uint4* row = reinterpret_cast<const uint4*>(sK + tid * PITCH);
  uint4 krow[kRegK ? D / 8 : 1];
  if (kRegK && keep) {
#pragma unroll
    for (int v8 = 0; v8 < (kRegK ? D / 8 : 1); ++v8) krow[v8] = row[v8];
  }
  float* sc = a.scores + (row0 * a.nT + t) * kTile + tid;
  for (int g = 0; g < G; ++g) {
    float s = 0.0f;
    if (keep) {
      const float* qg = sQ + g * D;
#pragma unroll
      for (int v8 = 0; v8 < D / 8; ++v8) {
        uint4 kv;
        if constexpr (kRegK)
          kv = krow[v8];
        else
          kv = row[v8];
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&kv);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s = fmaf(qg[v8 * 8 + j], __bfloat162float(e[j]), s);
      }
    }
    const float val = keep ? s : kNegInf;
    if (kp < x.kend) sc[(long long)g * a.nT * kTile] = val;
    const float mx = warp_max(val);
    if (lane == 0) sMax[warp * kMaxG + g] = mx;
  }
  __syncthreads();
  if (tid < G) {
    float mx = sMax[tid];
#pragma unroll
    for (int w = 1; w < kTile / 32; ++w)
      mx = fmaxf(mx, sMax[w * kMaxG + tid]);
    a.tmax[(row0 + tid) * a.nT + t] = mx;
  }
}

// ---- stage 3 (run by the row's last stage-2 CTA): the in-order chain
// over update blocks, then the mode's epilogue. Tile statistics are
// fetched kChain tiles at a time into registers, so the chain waits on
// one round trip per chunk (reads bypass L1: other CTAs wrote them); each
// block's alpha came from its tiles in stage 2, so the chain itself is
// f32 multiplies and adds.
constexpr int kChain = 8;

template <int D, int MODE>
__device__ void combine_row(const Args& a, int b, int h, int lo, int len) {
  const int G = a.G;
  const long long row0 = ((long long)b * a.Hkv + h) * G;
  const int t_first = lo / a.block * a.tpb;
  const int t_last = (len + a.block - 1) / a.block * a.tpb;
  for (int i = threadIdx.x; i < G * D; i += kPvThreads) {
    const int g = i / D, d = i % D;
    const long long r = row0 + g;
    float m = kNegInf, l = 0.0f, acc = 0.0f;      // chained so far
    float lb = 0.0f, pb = 0.0f, alpha = 1.0f;     // the current block
    for (int t0 = t_first; t0 < t_last; t0 += kChain) {
      float tm[kChain], tlv[kChain], tav[kChain], tp[kChain];
      bool live[kChain];
#pragma unroll
      for (int u = 0; u < kChain; ++u) {
        const int t = t0 + u;
        const Tile x = tile_of(a, t, lo, len);
        live[u] = t < t_last && x.c0 < x.c1;    // else no statistics
        const long long j = r * a.nT + t;
        tm[u] = live[u] ? __ldcg(a.tmax + j) : kNegInf;
        tlv[u] = live[u] ? __ldcg(a.tl + j) : 0.0f;
        tav[u] = live[u] ? __ldcg(a.ta + j) : 1.0f;
        tp[u] = live[u] ? __ldcg(a.tpv + j * D + d) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kChain; ++u) {
        const int t = t0 + u;
        if (t >= t_last) break;
        if (live[u]) {
          m = fmaxf(m, tm[u]);
          lb = __fadd_rn(lb, tlv[u]);
          pb = __fadd_rn(pb, tp[u]);
          alpha = tav[u];
        }
        if ((t + 1) % a.tpb == 0) {              // end of update block
          l = __fadd_rn(__fmul_rn(l, alpha), lb);
          acc = __fadd_rn(__fmul_rn(acc, alpha), pb);
          lb = 0.0f;
          pb = 0.0f;
        }
      }
    }
    // a row with no kept key keeps the merge identity (-1e30, 0, 0)
    if constexpr (MODE == kNormalized) {
      const float inv = 1.0f / fmaxf(l, 1e-30f);
      static_cast<__nv_bfloat16*>(a.o)[r * D + d] =
          __float2bfloat16_rn(__fmul_rn(acc, inv));
    } else if constexpr (MODE == kPartial) {
      static_cast<float*>(a.o)[r * D + d] = acc;
      if (d == 0) {
        a.om[r] = m;
        a.ol[r] = l;
      }
    } else {
      float* out = static_cast<float*>(a.o) + r * (D + 2);
      out[d] = acc;
      if (d == 0) {
        out[D] = m;
        out[D + 1] = l;
      }
    }
  }
}

// The lead CTA's walk over its update block (block_chain): for each live
// tile from the lead's on, p against the block's running max sM (the V
// rows of the lead's own tile are already in flight), then every
// thread's outputs (rows g, columns tid + 128 u) and warp 0's row sums
// chain over the tile's kept keys in order. Writes the block's l and
// p @ v into the lead tile's slots.
template <int D, bool PAGED>
__device__ __forceinline__ void chain_block(const Args& a, int b, int h,
                                            int t, int lo, int len,
                                            long long row0, const float* sM,
                                            __nv_bfloat16* sV, float* sP,
                                            float* sPr) {
  constexpr int kMaxG = max_g<D>();
  constexpr int CPT = D / kPvThreads;
  constexpr int PER = kMaxG * kTile / kPvThreads;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = a.G;
  float acc[kMaxG][CPT];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int u = 0; u < CPT; ++u) acc[g][u] = 0.0f;
  float lsum = 0.0f;                     // warp 0, lane g: row g's l
  const int t_end = (t / a.tpb + 1) * a.tpb;
  for (int tt = t; tt < t_end; ++tt) {
    const Tile y = tile_of(a, tt, lo, len);
    if (y.c0 >= y.c1) break;             // live tiles are contiguous
    if (tt != t) {
      __syncthreads();                   // the last tile's V and p read
      load_rows<D, PAGED, kPvThreads>(a, a.v, b, h, page_of<PAGED>(a, b, tt),
                                      y, sV, D);
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * kPvThreads, g = i / kTile, c = i % kTile;
      const int kp = y.k0 + c;
      if (g < G) {
        const float p =
            (kp >= y.c0 && kp < y.c1)
                ? vexp::apply_exp(
                      a.backend,
                      __fsub_rn(a.scores[((row0 + g) * a.nT + tt) * kTile + c],
                                sM[g]))
                : 0.0f;
        sP[i] = p;
        sPr[i] = bf16_round(p);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const int c0 = y.c0 - y.k0, c1 = y.c1 - y.k0;
    if (warp == 0 && lane < G)
      for (int c = c0; c < c1; ++c)
        lsum = __fadd_rn(lsum, sP[lane * kTile + c]);
    for (int c = c0; c < c1; ++c) {
      float vr[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u)
        vr[u] = __bfloat162float(sV[c * D + tid + u * kPvThreads]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float pr = sPr[g * kTile + c];
#pragma unroll
          for (int u = 0; u < CPT; ++u) acc[g][u] = fmaf(pr, vr[u], acc[g][u]);
        }
      }
    }
  }
  if (warp == 0 && lane < G) a.tl[(row0 + lane) * a.nT + t] = lsum;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G)
#pragma unroll
      for (int u = 0; u < CPT; ++u)
        a.tpv[((row0 + g) * a.nT + t) * D + tid + u * kPvThreads] = acc[g][u];
}


// ---- stage 2: p against the block's running max, the tile's l and
// p @ v; then a ticket per row, and the row's last CTA runs stage 3
// (at most 64 registers a thread, 8 CTAs per SM: the combine's prefetch
// would otherwise take the registers of half of them)
template <int D, int MODE, bool PAGED>
__global__ void __launch_bounds__(kPvThreads, 8) split_pv(Args a) {
  static_assert(!block_chain<D>(), "D = 256 takes split_pv_chain");
  constexpr int kMaxG = max_g<D>();
  constexpr int KG = kPvThreads / D;      // key groups in p @ v
  constexpr int WARPS = kPvThreads / 32;
  // V rows, p, p rounded to bf16, p @ v partials
  constexpr int kFloats =
      kTile * D / 2 + 2 * kMaxG * kTile + KG * kMaxG * D;
  __shared__ __align__(16) float smem[kFloats];
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sP = smem + kTile * D / 2;
  float* sPr = sP + kMaxG * kTile;
  float* sPart = sPr + kMaxG * kTile;
  __shared__ float sM[kMaxG];
  __shared__ bool sLast;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int PER = kMaxG * kTile / kPvThreads;   // scores per thread
  const int G = a.G;
  const long long row0 = ((long long)b * a.Hkv + h) * G;
  const long long phys = page_of<PAGED>(a, b, t);
  int lo, len;
  kept_range(a, b, lo, len);
  const Tile x = tile_of(a, t, lo, len);
  const bool live = x.c0 < x.c1;          // else no (l, p @ v)
  // V is not stage 1's output: its copy starts before the wait
  if (live) load_rows<D, PAGED, kPvThreads>(a, a.v, b, h, phys, x, sV, D);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (live) {
    // this thread's scores and the tile maxes of blocks 0..j, both in
    // flight at once
    float sv[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * kPvThreads, g = i / kTile, c = i % kTile;
      const int kp = x.k0 + c;
      sv[u] = (g < G && kp >= x.c0 && kp < x.c1)
          ? a.scores[((row0 + g) * a.nT + t) * kTile + c] : 0.0f;
    }
    // m_{j-1} and m_j over the maxes of every tile of blocks 0..j-1 and
    // 0..j; the block's alpha_j = exp(m_{j-1} - m_j) goes to stage 3
    const int t_mid = x.blk * a.tpb, t_end = t_mid + a.tpb;
    for (int g = warp; g < G; g += WARPS) {
      const float* tm = a.tmax + (row0 + g) * a.nT;
      float before = kNegInf, mx = kNegInf;
      for (int i = lane; i < t_end; i += 32) {
        const float v = tm[i];
        if (i < t_mid) before = fmaxf(before, v);
        mx = fmaxf(mx, v);
      }
      before = warp_max(before);
      mx = warp_max(mx);
      if (lane == 0) {
        sM[g] = mx;
        a.ta[(row0 + g) * a.nT + t] =
            vexp::apply_exp(a.backend, __fsub_rn(before, mx));
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * kPvThreads, g = i / kTile, c = i % kTile;
      const int kp = x.k0 + c;
      if (g < G) {
        const float p = (kp >= x.c0 && kp < x.c1)
            ? vexp::apply_exp(a.backend, __fsub_rn(sv[u], sM[g])) : 0.0f;
        sP[i] = p;
        sPr[i] = bf16_round(p);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // the tile's l: one warp per query row, a fixed-order tree
    for (int g = warp; g < G; g += WARPS) {
      float sum = __fadd_rn(sP[g * kTile + lane], sP[g * kTile + lane + 32]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      if (lane == 0) a.tl[(row0 + g) * a.nT + t] = sum;
    }
    // p @ v: KG key groups x D columns, one query row at a time
    const int d = tid % D, kg = tid / D;
    for (int g = 0; g < G; ++g) {
      const float* pr = sPr + g * kTile;
      float acc = 0.0f;
      for (int c = x.c0 - x.k0 + kg; c < x.c1 - x.k0; c += KG)
        acc = fmaf(pr[c], __bfloat162float(sV[c * D + d]), acc);
      sPart[(kg * kMaxG + g) * D + d] = acc;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kPvThreads) {
      const int g = i / D, dd = i % D;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < KG; ++j)
        s = __fadd_rn(s, sPart[(j * kMaxG + g) * D + dd]);
      a.tpv[((row0 + g) * a.nT + t) * D + dd] = s;
    }
  }
  // every CTA of the row takes a ticket once its writes are visible (the
  // barrier orders the CTA's writes before thread 0's device-scope fence);
  // the one that takes the last runs the combine (stage 1 zeroed the count)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    sLast = atomicAdd(a.tickets + (long long)b * a.Hkv + h, 1u) ==
            gridDim.x - 1;
  }
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  combine_row<D, MODE>(a, b, h, lo, len);
}

// ---- stage 2 at D = 256 (block_chain): the same alphas as split_pv,
// then the first live tile's CTA of each update block (the lead) walks
// the block's live tiles in order, each thread chaining its 16 x 2
// outputs of p @ v, and warp 0 each row's l, over the block's keys in
// order: the order of the plain sweep's products (one (d, keys) @
// (keys, G) product a block, which the card sums in key order). The
// block's other tiles write l = 0 and p @ v = 0, so stage 3's sum over a
// block's tiles is the lead's chain exactly. Then the ticket and stage 3
// as in split_pv.
template <int D, int MODE, bool PAGED>
__global__ void __launch_bounds__(kPvThreads, 4) split_pv_chain(Args a) {
  constexpr int kMaxG = max_g<D>();
  constexpr int WARPS = kPvThreads / 32;
  // V rows, p, p rounded to bf16: 40 KB at D = 256
  __shared__ __align__(16) float smem[kTile * D / 2 + 2 * kMaxG * kTile];
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sP = smem + kTile * D / 2;
  float* sPr = sP + kMaxG * kTile;
  __shared__ float sM[kMaxG];
  __shared__ bool sLast;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = a.G;
  const long long row0 = ((long long)b * a.Hkv + h) * G;
  int lo, len;
  kept_range(a, b, lo, len);
  const Tile x = tile_of(a, t, lo, len);
  const bool live = x.c0 < x.c1;
  const int b0 = x.blk * a.block;
  const bool lead =
      live && t == x.blk * a.tpb + (max(b0, lo) - b0) / kTile;
  // the lead's first V tile is not stage 1's output: it starts now
  if (lead)
    load_rows<D, PAGED, kPvThreads>(a, a.v, b, h, page_of<PAGED>(a, b, t),
                                    x, sV, D);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (live) {
    const int t_mid = x.blk * a.tpb, t_end = t_mid + a.tpb;
    for (int g = warp; g < G; g += WARPS) {
      const float* tm = a.tmax + (row0 + g) * a.nT;
      float before = kNegInf, mx = kNegInf;
      for (int i = lane; i < t_end; i += 32) {
        const float v = tm[i];
        if (i < t_mid) before = fmaxf(before, v);
        mx = fmaxf(mx, v);
      }
      before = warp_max(before);
      mx = warp_max(mx);
      if (lane == 0) {
        sM[g] = mx;
        a.ta[(row0 + g) * a.nT + t] =
            vexp::apply_exp(a.backend, __fsub_rn(before, mx));
      }
    }
    __syncthreads();
    if (lead) {
      chain_block<D, PAGED>(a, b, h, t, lo, len, row0, sM, sV, sP, sPr);
    } else {
      for (int i = tid; i < G * D; i += kPvThreads) {
        const int g = i / D;
        if (i % D == 0) a.tl[(row0 + g) * a.nT + t] = 0.0f;
        a.tpv[((row0 + g) * a.nT + t) * D + i % D] = 0.0f;
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    sLast = atomicAdd(a.tickets + (long long)b * a.Hkv + h, 1u) ==
            gridDim.x - 1;
  }
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  combine_row<D, MODE>(a, b, h, lo, len);
}

// Fills the tile geometry and scratch pointers of `a` (whose B, Hkv, G,
// S and block are set) and launches the two kernels. Returns a CUDA
// error code: invalid arguments, too little scratch, or the first launch
// that failed.
template <int D, int MODE, bool PAGED>
int launch(Args a, float* scratch, long long scratch_len,
           cudaStream_t stream) {
  if (a.G > max_g<D>()) return (int)cudaErrorInvalidValue;
  a.block = max(min(a.block, a.S), 1);
  a.tpb = (a.block + kTile - 1) / kTile;
  a.nT = max((a.S + a.block - 1) / a.block * a.tpb, 1);
  if (scratch_floats(a.B, a.Hkv, a.G, D, a.nT) > scratch_len)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)a.B * a.Hkv * a.G * a.nT;
  a.scores = scratch;
  a.tmax = a.scores + tiles * kTile;
  a.tl = a.tmax + tiles;
  a.ta = a.tl + tiles;
  a.tpv = a.ta + tiles;
  a.tickets = reinterpret_cast<unsigned*>(a.tpv + tiles * D);
  // stage 2's kernel: per-tile partials, or at D = 256 the block chain
  void (*pv)(Args);
  if constexpr (block_chain<D>())
    pv = split_pv_chain<D, MODE, PAGED>;
  else
    pv = split_pv<D, MODE, PAGED>;
  // as many CTAs per SM as shared memory allows, and stage 1's dynamic
  // shared memory at D = 256 (above the 48 KB default) allowed (set once
  // per process)
  static const cudaError_t carveout = [pv] {
    cudaError_t e = cudaFuncSetAttribute(
        split_scores<D, PAGED>, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(pv,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (dyn_smem<D>() && e == cudaSuccess)
      e = cudaFuncSetAttribute(split_scores<D, PAGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)scores_smem<D>());
    return e;
  }();
  if (carveout != cudaSuccess) return (int)carveout;
  const dim3 grid(a.nT, a.Hkv, a.B);
  split_scores<D, PAGED>
      <<<grid, kTile, dyn_smem<D>() ? scores_smem<D>() : 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // stage 2 as a programmatic dependent launch: its CTAs start while
  // stage 1 drains and copy their V rows before waiting on stage 1
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kPvThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pv, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `launch` for the head dims the port instantiates (gpt2-small's 64 and
// its --reduced form's 32, in every mode; recurrentgemma's 256 in the
// normalized mode only: the hybrid never shards its sequence).
template <int MODE, bool PAGED>
int run(const Args& a, int D, float* scratch, long long scratch_len,
        cudaStream_t stream) {
  if (a.B == 0) return 0;
  if (a.G < 1 || a.block < 1 || a.S < 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return launch<32, MODE, PAGED>(a, scratch, scratch_len, stream);
    case 64:
      return launch<64, MODE, PAGED>(a, scratch, scratch_len, stream);
    case 256:
      if constexpr (MODE == kNormalized)
        return launch<256, MODE, PAGED>(a, scratch, scratch_len, stream);
      else
        return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace split
