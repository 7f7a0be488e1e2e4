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
// Head dims 128 and 256 (block_chain: phi3-medium's 4 query heads a KV
// head, dbrx's 6, recurrentgemma's 16 on one; normalized mode only) run
// three kernels of their own, in one of three tiers of query rows a KV
// head chosen by G at launch (chain_rows): at D 128 four rows for G <= 4
// and eight for 5 <= G <= 8, whose stage 2 is split_pv_rows (below) and
// computes no FMA of a row past G; else sixteen rows (rows past G are
// computed and not written), spread over the card by query rows in stage
// 1, by column slices in stage 2 and by outputs in stage 3; every f32
// operation of every output, and its order, is the one described above
// for the block's keys:
//   1. split_scores_rows, one CTA per (tile, h, b) of 128 threads: a
//      warp per four query rows at sixteen rows a KV head, per two
//      adjacent rows at eight (a warp whose rows are all past G does no
//      FMA, one with a single live row chains it alone), per row at four;
//      a lane per two keys, eight (four, two) f32 FMA chains over d from
//      0 a thread in flight together, K rows and q read from shared
//      memory (dynamic, 49 KB; 21 KB at D 128 and eight rows);
//   2. split_pv_slice, one CTA per (update block, column slice of 64, h,
//      b), D / 64 slices a row (4 at D 256, 2 at D 128): the block's m_j
//      and alpha_j as
//      above, p against m_j for the block's kept keys (each slice takes
//      the same exps; p goes to shared memory rounded to bf16, which it
//      is exactly), then each thread chains 4 query rows x 2 columns
//      of p @ v over the block's kept keys in key order from +0.0, the
//      next 64-key tile's V columns copied (cp.async, two buffers) while
//      the current one chains; warp 0 of slice 0 also chains each row's
//      l in key order. That is the order in which the plain sweep's
//      key-major products sum on the card (one (d, keys) @ (keys, G)
//      product a block), so the kernels match their plain versions bit
//      for bit. One (alpha, l, p @ v) slot per block. Four slices, not
//      more: a CTA's shared-memory reads per key grow with its rows, not
//      its columns (every lane of a warp takes the same p), and at
//      recurrentgemma's ring (4 blocks a row) 4 slices give at most one
//      block CTA an SM. A programmatic dependent launch only where its
//      grid has more CTAs than the card has SMs;
//   3. combine_blocks, a programmatic dependent launch after stage 2, one
//      thread per (query row, four columns): the blocks chained in order,
//      every block's (alpha, l, p @ v) loaded before its chain starts
//      (kBatch blocks a load). Not the last CTA of each slice, as at the
//      dense heads: there the combine ran on a few CTAs at the kernel's
//      tail (7.6 µs of stage 2 on a page-64 ring, on an H100).
// At four and eight rows a KV head stage 2 is split_pv_rows: one CTA per
// (update block, h, b) takes all D columns (the exps once a block), four
// warps chaining a column and R rows a lane (R = 4; 6 at G 5 and 6, 8 at
// G 7 and 8) and a fifth warp the l chains, a 16-byte load of four of a
// key's p (eight-byte for the last two of six) a step.
// (Each choice read on the card by tools/decode_split_ablation.py.)
// D 32 and 64 (G <= 8) keep split_scores and split_pv.
// Head dim 120 (h2o-danube3: 4 query heads a KV head) runs the D 128
// kernels instantiated with DV = 120, the columns of the tensors' rows:
// K and V rows arrive as 15 16-byte chunks and a zero chunk, q as 120
// values and 8 zeros, so each score's chain ends in exact +0 terms and
// the chains of columns 120-127 run on zeros; the scratch keeps 128
// columns a row, and stage 3 writes 120. Every other head dim has DV = D,
// where that code folds away.
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
// r = (b * Hkv + h) * G + g, R = B * Hkv * G, nT tiles and nB update
// blocks per row. D 32, 64: scores R * nT * kTile, tile maxes R * nT,
// tile l R * nT, the tile's block alpha R * nT, tile p @ v R * nT * D,
// then B * Hkv ticket counters. D 128, 256: scores B * Hkv * nT * kTile *
// chain_rows(D, G) (each tile's keys by query row, [key][16], or at D 128
// [key][4] for G <= 4 and [key][8] for 5 <= G <= 8), block p @ v R * nB *
// D, tile maxes R * nT, block alpha R * nB, block l R * nB.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vexp.cuh"

namespace split {

constexpr int kTile = 64;             // keys per tile, one thread each
constexpr int kPvThreads = 128;
// the smallest head dim that chains each update block (block_chain)
constexpr int kChainMinD = 128;
// D >= kChainMinD: query rows a KV head, stage 1's row groups, stage 2's
// columns a slice, the blocks whose statistics the combine loads at
// once, and the keys whose operands the chain loads at once
constexpr int kChainG = 16;
// D = 128 at G <= 4 (phi3-medium's 4 query heads a KV head) and at 5 <= G
// <= 8 (dbrx's 6): the scores' rows a key of an instantiation of its own,
// chosen by G at launch
constexpr int kChainG4 = 4;
constexpr int kChainG8 = 8;
// the eight-row tier's stage 2 chains six rows up to this G, else eight
constexpr int kChainG6 = 6;
// their stage 2: four warps chaining p @ v, a column and R query rows a
// lane (D 128), one more warp chaining l
constexpr int kRowsChain = 128;
constexpr int kRowsThreads = kRowsChain + 32;
// keys whose operands a chain loads at once: R + 1 registers a key
constexpr int kRowsUnroll4 = 16;
constexpr int kRowsUnroll8 = 8;
// their stage 2's V tiles in flight or held a CTA, at most: 64 KB, 3
// CTAs an SM, so the 320 block CTAs of phi3-medium's decode (4 blocks of
// 512 keys a row) are all resident; with one barrier a tile two buffers
// would leave a single tile in flight, which on an H100 reads slower
// (PERF.md). A page of fewer tiles (64 keys: one) takes as many buffers
// as it has tiles (rows_bufs)
constexpr int kRowsBufs = 4;
constexpr int kRowSplit = 4;          // stage 1: warps a tile, 4 rows each
constexpr int kScoreThreads = 32 * kRowSplit;
constexpr int kSliceCols = 64;
constexpr int kBatch = 8;
constexpr int kUnroll = 8;            // keys a step of stage 2's chain
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
  float* tmax;              // each tile's max
  float* tl;                // l: each tile's (chained D: each block's)
  float* ta;                // alpha_j: each tile's block's (chained: a block's)
  float* tpv;               // p @ v: each tile's (chained D: each block's)
  unsigned* tickets;        // stage-2 CTAs done per row (D 32, 64)
  int B, Hkv, G, S;         // S: keys in the slice (paged: nS * page)
  int nS;                   // paged: table columns
  int block;                // update block, >= 1 (the page when paged)
  int tpb;                  // tiles per update block
  int nT;                   // tiles per row
  int nB;                   // update blocks per row (nT = nB * tpb)
  long long sb, sh, ss;     // strides of a batch row (pool page), head, key
  float sm_scale;
  int window, seq_offset, backend;
};

// Whether the sweep chains each update block's p @ v and l over the
// block's keys in order, by column slices (split_scores_rows,
// split_pv_slice; D = 128 and 256), instead of summing per-tile partials
// (split_scores, split_pv; D = 32 and 64). The chain is the order of the
// plain sweep's key-major products on the card (KEY_MAJOR_DIMS in
// kernels/decode_attention.py).
template <int D>
__host__ __device__ constexpr bool block_chain() {
  return D >= kChainMinD;
}

// Query rows per KV head an instantiation takes: 8 at D 32, 64; 16 where
// the block chains (phi3-medium's 4 at D 128, recurrentgemma's 16 at D
// 256). Shared memory is sized by it, so the small heads keep theirs.
template <int D>
__host__ __device__ constexpr int max_g() {
  return block_chain<D>() ? kChainG : 8;
}

// Query rows a KV head the chained sweep's scores take at head dim D for
// G query heads a KV head: at D 128 4 for G <= 4 and 8 for G <= 8, else
// max_g<D>(). Stage 1, stage 2 and the scores' scratch are sized by it,
// so at phi3-medium's G 4 no FMA, exp or scratch byte goes to a row past
// G, and at dbrx's G 6 no FMA.
__host__ __device__ constexpr int chain_rows(int D, int G) {
  return D != 128 ? kChainG
         : G <= kChainG4 ? kChainG4
         : G <= kChainG8 ? kChainG8
                         : kChainG;
}

// Column slices of a row in stage 2 at a chained head dim.
template <int D>
__host__ __device__ constexpr int slices() {
  return D / kSliceCols;
}

// split_scores_rows' dynamic shared memory at MAXG rows a KV head, in
// bytes (above the 48 KB static limit at D = 256).
template <int D, int MAXG>
__host__ __device__ constexpr size_t rows_smem() {
  return (size_t)MAXG * D * sizeof(float) +                   // sQ
         (size_t)kTile * (D + 8) * sizeof(__nv_bfloat16);     // sK
}

// Floats of scratch a call needs (nT tiles, nB update blocks a row); the
// wrappers compute the same.
inline long long scratch_floats(int B, int Hkv, int G, int D, int nT,
                                int nB) {
  if (D >= kChainMinD)
    return (long long)B * Hkv *
           ((long long)nT * kTile * chain_rows(D, G) +
            G * ((long long)nT + (long long)nB * (D + 2)));
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

// 16 bytes of zeros into shared memory through the copy path (a source
// size of 0 reads nothing from src)
__device__ __forceinline__ void cp_async16_zero(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, 0;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// kept rows [c0, c1) of a tile -> shared rows (c - k0) of `pitch` bf16,
// D columns of which the first `cols` are copied and the rest zeroed;
// rows of one tile sit ss apart (a tile never crosses a page)
template <int D, bool PAGED, int THREADS>
__device__ __forceinline__ void load_rows(const Args& a,
                                          const __nv_bfloat16* base, int b,
                                          int h, long long phys,
                                          const Tile& x, __nv_bfloat16* dst,
                                          int pitch, int cols = D) {
  constexpr int CH = D / 8;               // 16-byte chunks per row
  const __nv_bfloat16* src =
      PAGED ? base + phys * a.sb + h * a.sh +
                  (long long)(x.c0 - x.blk * a.block) * a.ss
            : base + (long long)b * a.sb + h * a.sh + (long long)x.c0 * a.ss;
  __nv_bfloat16* out = dst + (x.c0 - x.k0) * pitch;
  const int n = (x.c1 - x.c0) * CH;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / CH, ch = i % CH;
    if (cols >= D || ch * 8 < cols)
      cp_async16(out + r * pitch + ch * 8, src + r * a.ss + ch * 8);
    else
      cp_async16_zero(out + r * pitch + ch * 8, src + r * a.ss);
  }
}

// ---- stage 1: scores and the tile's max
template <int D, bool PAGED>
__global__ void __launch_bounds__(kTile) split_scores(Args a) {
  static_assert(!block_chain<D>(), "a chained D takes split_scores_rows");
  constexpr int PITCH = D + 8;            // 16 bytes of padding per row
  constexpr int kMaxG = max_g<D>();
  __shared__ float sQ[kMaxG * D];
  __shared__ __align__(16) __nv_bfloat16 sK[kTile * PITCH];
  __shared__ float sMax[kTile / 32 * kMaxG];
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

  // the G query rows take their turns on the key's K row, held in
  // registers (a loop over the runtime G, so G = 1 issues no idle work)
  const int kp = x.k0 + tid;
  const bool keep = kp >= x.c0 && kp < x.c1;
  const uint4* row = reinterpret_cast<const uint4*>(sK + tid * PITCH);
  uint4 krow[D / 8];
  if (keep) {
#pragma unroll
    for (int v8 = 0; v8 < D / 8; ++v8) krow[v8] = row[v8];
  }
  float* sc = a.scores + (row0 * a.nT + t) * kTile + tid;
  for (int g = 0; g < G; ++g) {
    float s = 0.0f;
    if (keep) {
      const float* qg = sQ + g * D;
#pragma unroll
      for (int v8 = 0; v8 < D / 8; ++v8) {
        const uint4 kv = krow[v8];
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

// ---- stage 2: p against the block's running max, the tile's l and
// p @ v; then a ticket per row, and the row's last CTA runs stage 3
// (at most 64 registers a thread, 8 CTAs per SM: the combine's prefetch
// would otherwise take the registers of half of them)
template <int D, int MODE, bool PAGED>
__global__ void __launch_bounds__(kPvThreads, 8) split_pv(Args a) {
  static_assert(!block_chain<D>(), "a chained D takes split_pv_slice");
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

// ---- D = 128, 256 (block_chain), stage 1: a warp's query rows against a
// lane's two keys (lane, lane + 32): RPT rows first, first + STEP, ...
// (rows past G computed, not written), KPT x RPT f32 FMA chains over d
// from 0 a thread in flight together, so each q value read from shared
// memory feeds two keys and each K value RPT rows. Scores go to scratch as
// [key][MAXG] per tile, the rows of a key side by side for stage 2's
// loads; each warp's maxes are its rows' tile maxes.
template <int D, int MAXG, int RPT, int STEP>
__device__ __forceinline__ void score_rows(const Args& a, const float* sQ,
                                           const __nv_bfloat16* sK,
                                           const Tile& x, int first,
                                           int lane, float* sc,
                                           long long row0, int t) {
  constexpr int PITCH = D + 8;            // 16 bytes of padding per row
  constexpr int KPT = kTile / 32;         // keys a thread
  const int G = a.G;
  // every key and row each step, unkept keys and rows past G included
  // (their scores are replaced or never written): one basic block, the
  // rows' q and the keys' K columns first, then column by column one FMA
  // of each chain, so the chains interleave in program order
  int kp[KPT];
  bool keep[KPT];
  const uint4* krow[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    kp[k] = x.k0 + lane + 32 * k;
    keep[k] = kp[k] >= x.c0 && kp[k] < x.c1;
    krow[k] = reinterpret_cast<const uint4*>(sK + (lane + 32 * k) * PITCH);
  }
  float s[KPT][RPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k)
#pragma unroll
    for (int i = 0; i < RPT; ++i) s[k][i] = 0.0f;
#pragma unroll 2
  for (int v8 = 0; v8 < D / 8; ++v8) {
    float kf[KPT][8];
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const uint4 kv = krow[k][v8];
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&kv);
#pragma unroll
      for (int j = 0; j < 8; ++j) kf[k][j] = __bfloat162float(e[j]);
    }
    float q[RPT][8];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float4* qv = reinterpret_cast<const float4*>(
          sQ + (first + STEP * i) * D + v8 * 8);
      const float4 q0 = qv[0], q1 = qv[1];
      q[i][0] = q0.x; q[i][1] = q0.y; q[i][2] = q0.z; q[i][3] = q0.w;
      q[i][4] = q1.x; q[i][5] = q1.y; q[i][6] = q1.z; q[i][7] = q1.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int k = 0; k < KPT; ++k)
          s[k][i] = fmaf(q[i][j], kf[k][j], s[k][i]);
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int g = first + STEP * i;
    if (g < G) {                          // the same for the whole warp
      float mx = kNegInf;
#pragma unroll
      for (int k = 0; k < KPT; ++k) {
        const float val = keep[k] ? s[k][i] : kNegInf;
        if (kp[k] < x.kend) sc[(lane + 32 * k) * MAXG + g] = val;
        mx = fmaxf(mx, val);
      }
      mx = warp_max(mx);
      if (lane == 0) a.tmax[(row0 + g) * a.nT + t] = mx;
    }
  }
}

// one CTA per (tile, h, b) of kScoreThreads: at MAXG 16 a warp per four
// rows (quarter, quarter + 4, ...), at MAXG 4 a warp per row, at MAXG 8
// a warp per two adjacent rows, so that at G 5 to 7 a warp whose rows are
// all past G does no FMA and one with a single live row chains it alone.
// q, K and V rows hold DV <= D columns (the rest zero-filled here).
template <int D, bool PAGED, int MAXG, int DV = D>
__global__ void __launch_bounds__(kScoreThreads) split_scores_rows(Args a) {
  static_assert(block_chain<D>(), "the dense heads take split_scores");
  constexpr int PITCH = D + 8;            // 16 bytes of padding per row
  constexpr int kMaxG = MAXG;
  constexpr int RPT = kMaxG / kRowSplit;  // query rows a warp
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* sQ = reinterpret_cast<float*>(dsmem);                 // [kMaxG][D]
  __nv_bfloat16* sK =
      reinterpret_cast<__nv_bfloat16*>(sQ + kMaxG * D);        // [kTile][PITCH]
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, quarter = tid / 32;
  const int G = a.G;
  const long long bh = (long long)b * a.Hkv + h, row0 = bh * G;
  // stage 2 may launch now: it waits for this grid before reading its
  // output (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;");
  const long long phys = page_of<PAGED>(a, b, t);
  int lo, len;
  kept_range(a, b, lo, len);
  const Tile x = tile_of(a, t, lo, len);
  if (x.c0 >= x.c1) {
    if (tid < G) a.tmax[(row0 + tid) * a.nT + t] = kNegInf;
    return;
  }
  load_rows<D, PAGED, kScoreThreads>(a, a.k, b, h, phys, x, sK, PITCH, DV);
  if constexpr (DV == D) {
    for (int i = tid; i < G * D; i += kScoreThreads)
      sQ[i] = bf16_round(
          __fmul_rn(__bfloat162float(a.q[row0 * D + i]), a.sm_scale));
  } else {                                // q rows of DV columns, zero-filled
    for (int i = tid; i < G * D; i += kScoreThreads) {
      const int g = i / D, d = i % D;
      sQ[i] = d < DV ? bf16_round(__fmul_rn(
                           __bfloat162float(a.q[(row0 + g) * DV + d]),
                           a.sm_scale))
                     : 0.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  float* sc = a.scores + (bh * a.nT + t) * kTile * kMaxG;
  if constexpr (kMaxG == kChainG8) {
    static_assert(RPT == 2, "a warp per two adjacent rows");
    const int first = RPT * quarter;      // the same for the whole warp
    if (first + 1 < G)
      score_rows<D, kMaxG, 2, 1>(a, sQ, sK, x, first, lane, sc, row0, t);
    else if (first < G)
      score_rows<D, kMaxG, 1, 1>(a, sQ, sK, x, first, lane, sc, row0, t);
  } else {
    score_rows<D, kMaxG, RPT, kRowSplit>(a, sQ, sK, x, quarter, lane, sc,
                                         row0, t);
  }
}

// whether update block j holds a kept key
__device__ __forceinline__ bool block_live(const Args& a, int j, int lo,
                                           int len) {
  const int b0 = j * a.block;
  return max(b0, lo) < min(min(b0 + a.block, a.S), len);
}

template <int BK>
__device__ __forceinline__ float exp_as(float x) {
  if constexpr (BK == vexp::kExact)
    return vexp::exact_exp(x);
  else if constexpr (BK == vexp::kVexp)
    return vexp::vexp_f32(x);
  else
    return vexp::vexp_hw(x);
}

// p = exp(s - m) of a thread's PER (key, row) pairs of a tile, keys k0 <=
// u * CSTEP < k1 counted from the thread's first key, 0 elsewhere; p
// rounded to bf16 (exact in bf16) and p go to shared memory kPvThreads
// elements apart
template <int BK, int PER, int CSTEP>
__device__ __forceinline__ void tile_p(const float (&sv)[PER], float m,
                                       int k0, int k1, bool grow,
                                       __nv_bfloat16* pr, float* pu) {
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int c = u * CSTEP;
    // taken for every pair, then masked: no branch keeps the PER exps
    // apart
    const float e = exp_as<BK>(__fsub_rn(sv[u], m));
    const float p = (grow && c >= k0 && c < k1) ? e : 0.0f;
    pr[u * kPvThreads] = __float2bfloat16_rn(p);
    pu[u * kPvThreads] = p;
  }
}

// one key of a thread's chains: 4 rows of p (bf16-rounded) times the
// key's 2 V columns, and (WITH_L) its row's unrounded p into l
template <bool WITH_L>
__device__ __forceinline__ void chain_key(float (&acc)[4][2], float& lsum,
                                          float4 p4, float2 v, float pu) {
  acc[0][0] = fmaf(p4.x, v.x, acc[0][0]);
  acc[0][1] = fmaf(p4.x, v.y, acc[0][1]);
  acc[1][0] = fmaf(p4.y, v.x, acc[1][0]);
  acc[1][1] = fmaf(p4.y, v.y, acc[1][1]);
  acc[2][0] = fmaf(p4.z, v.x, acc[2][0]);
  acc[2][1] = fmaf(p4.z, v.y, acc[2][1]);
  acc[3][0] = fmaf(p4.w, v.x, acc[3][0]);
  acc[3][1] = fmaf(p4.w, v.y, acc[3][1]);
  if constexpr (WITH_L) lsum = __fadd_rn(lsum, pu);
}

// a thread's chains over a tile's kept keys [c0, c1), in key order:
// kUnroll keys' operands loaded, then their FMAs. Rounded p (4 rows in
// bf16, one 8-byte load) rows are PS apart, unrounded p rows PS floats,
// V rows VS bf16 (two columns a thread, one 4-byte load); bf16 widens to
// f32 exactly.
template <bool WITH_L, int PS, int VS>
__device__ __forceinline__ void chain_tile(float (&acc)[4][2], float& lsum,
                                           const __nv_bfloat16* pr,
                                           const __nv_bfloat16* vc,
                                           const float* pl, int c0, int c1) {
  // a bf16 is the top half of its f32: the low element of a word shifts
  // up, the high one is masked
  auto v_at = [&](int c) {
    const unsigned w = *reinterpret_cast<const unsigned*>(vc + c * VS);
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  };
  auto p_at = [&](int c) {
    const uint2 u = *reinterpret_cast<const uint2*>(pr + c * PS);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  };
  int c = c0;
  for (; c + kUnroll <= c1; c += kUnroll) {
    float4 p4[kUnroll];
    float2 v[kUnroll];
    float pu[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      p4[k] = p_at(c + k);
      v[k] = v_at(c + k);
      pu[k] = WITH_L ? pl[(c + k) * PS] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      chain_key<WITH_L>(acc, lsum, p4[k], v[k], pu[k]);
  }
  for (; c < c1; ++c)
    chain_key<WITH_L>(acc, lsum, p_at(c), v_at(c),
                      WITH_L ? pl[c * PS] : 0.0f);
}

// ---- D = 128, 256, stage 3: a kernel of its own after stage 2, one thread
// per (query row, four columns), spread over the card: the outputs
// chained over the row's live update blocks in order, l = l * alpha_j +
// l_j and acc = acc * alpha_j + pv_j, rounded step by step, kBatch
// blocks' statistics loaded at once before their chain.
template <int D, int DV = D>
__global__ void __launch_bounds__(kPvThreads) combine_blocks(Args a) {
  constexpr int QPR = DV / 4;             // four-column groups a row
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long i = (long long)blockIdx.x * kPvThreads + threadIdx.x;
  const long long r = i / QPR;            // (b * Hkv + h) * G + g
  if (r >= (long long)a.B * a.Hkv * a.G) return;
  const int col = (int)(i % QPR) * 4;
  int lo, len;
  kept_range(a, (int)(r / a.G / a.Hkv), lo, len);
  const int j_first = lo / a.block, j_last = (len + a.block - 1) / a.block;
  float l = 0.0f, acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j0 = j_first; j0 < j_last; j0 += kBatch) {
    float al[kBatch], lb[kBatch];
    float4 pb[kBatch];
    bool live[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u;
      live[u] = j < j_last && block_live(a, j, lo, len);
      const long long s = r * a.nB + j;  // read from L2: stage 2 wrote it
      al[u] = live[u] ? __ldcg(a.ta + s) : 1.0f;
      lb[u] = live[u] ? __ldcg(a.tl + s) : 0.0f;
      pb[u] = live[u] ? __ldcg(reinterpret_cast<const float4*>(
                            a.tpv + s * D + col))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!live[u]) continue;
      l = __fadd_rn(__fmul_rn(l, al[u]), lb[u]);
      acc[0] = __fadd_rn(__fmul_rn(acc[0], al[u]), pb[u].x);
      acc[1] = __fadd_rn(__fmul_rn(acc[1], al[u]), pb[u].y);
      acc[2] = __fadd_rn(__fmul_rn(acc[2], al[u]), pb[u].z);
      acc[3] = __fadd_rn(__fmul_rn(acc[3], al[u]), pb[u].w);
    }
  }
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + r * DV + col;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = __float2bfloat16_rn(__fmul_rn(acc[k], inv));
}

// ---- D = 128, 256, stage 2: one CTA per (update block j, column slice sl,
// h, b). m_{j-1} and m_j from the tile maxes of blocks 0..j-1 and 0..j
// (slice 0 writes the block's alpha_j); then, tile by tile over the
// block's live tiles, p = exp(s - m_j) for the tile's kept keys into
// shared memory, and each thread's 4 rows x 2 columns of p @ v (and, in
// slice 0, lanes g < G of warp 0: row g's l) chained over the tile's
// kept keys in order from +0.0. The V columns of the next tile are in
// flight during a tile's chain (two buffers), the next tile's scores in
// registers. Writes the block's p @ v columns (and l).
template <int D, bool PAGED, int DV = D>
__global__ void __launch_bounds__(kPvThreads, 6) split_pv_slice(Args a) {
  constexpr int kMaxG = max_g<D>();
  constexpr int SC = kSliceCols;                   // columns a slice
  constexpr int WARPS = kPvThreads / 32;
  constexpr int RPW = kMaxG / WARPS;               // query rows a warp
  constexpr int PER = kMaxG * kTile / kPvThreads;  // (key, row) pairs a thread
  constexpr int CSTEP = kPvThreads / kMaxG;        // keys between a thread's
  static_assert(SC == 64 && RPW == 4,
                "a warp chains 4 rows x 64 columns, 2 a lane");
  __shared__ __align__(16) __nv_bfloat16 sV[2][kTile * SC];  // [key][col]
  __shared__ __align__(16) __nv_bfloat16 sPr[2][kTile * kMaxG];  // [key][g]
  __shared__ __align__(16) float sP[2][kTile * kMaxG];       // unrounded
  __shared__ float sM[kMaxG];
  const int j = blockIdx.x / slices<D>(), sl = blockIdx.x % slices<D>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = a.G;
  const long long bh = (long long)b * a.Hkv + h, row0 = bh * G;
  const __nv_bfloat16* vbase = a.v + sl * SC;
  // this slice's V columns
  const int vcols = DV == D ? SC : min(DV - sl * SC, SC);
  // stage 3 may launch now: it waits for this grid before reading its
  // output
  asm volatile("griddepcontrol.launch_dependents;");
  int lo, len;
  kept_range(a, b, lo, len);
  const bool live = block_live(a, j, lo, len);
  // the block's live tiles [t_lo, t_hi) (its kept keys are contiguous)
  int t_lo = 0, t_hi = 0;
  if (live) {
    const int b0 = j * a.block;
    t_lo = j * a.tpb + (max(b0, lo) - b0) / kTile;
    t_hi = j * a.tpb + (min(min(b0 + a.block, a.S), len) - 1 - b0) / kTile + 1;
    // V is not stage 1's output: the first two tiles' copies start now
    for (int u = 0; u < 2 && t_lo + u < t_hi; ++u) {
      load_rows<SC, PAGED, kPvThreads>(
          a, vbase, b, h, page_of<PAGED>(a, b, t_lo + u),
          tile_of(a, t_lo + u, lo, len), sV[u], SC, vcols);
      cp_async_commit();
    }
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (live) {
    const int t_mid = j * a.tpb, t_end = t_mid + a.tpb;
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
        if (sl == 0)
          a.ta[(row0 + g) * a.nB + j] =
              vexp::apply_exp(a.backend, __fsub_rn(before, mx));
      }
    }
    // this thread's (key, row) pairs of a tile: row pg, keys c_first +
    // u * CSTEP (scratch index [key][kMaxG] = tid + u * kPvThreads); the
    // first tile's scores
    const int pg = tid % kMaxG, c_first = tid / kMaxG;
    const bool grow = pg < G;
    float sv[PER];
    auto load_scores = [&](int tt) {
      const Tile y = tile_of(a, tt, lo, len);
      const float* src = a.scores + (bh * a.nT + tt) * kTile * kMaxG + tid;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int kp = y.k0 + c_first + u * CSTEP;
        sv[u] = (grow && kp >= y.c0 && kp < y.c1) ? src[u * kPvThreads]
                                                  : 0.0f;
      }
    };
    load_scores(t_lo);
    __syncthreads();                      // sM
    const float m_g = grow ? sM[pg] : 0.0f;
    const bool lwarp = sl == 0 && warp == 0;     // chains l
    const bool lchain = lwarp && lane < G;
    float acc[RPW][2];
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i][0] = acc[i][1] = 0.0f;
    float lsum = 0.0f;
    for (int tt = t_lo; tt < t_hi; ++tt) {
      const int buf = (tt - t_lo) & 1;
      const Tile y = tile_of(a, tt, lo, len);
      // the exp chosen once a tile, so the thread's PER exps interleave
      const int k0 = y.c0 - y.k0 - c_first, k1 = y.c1 - y.k0 - c_first;
      __nv_bfloat16* pr_out = sPr[buf] + tid;
      float* p_out = sP[buf] + tid;
      if (a.backend == vexp::kExact)
        tile_p<vexp::kExact, PER, CSTEP>(sv, m_g, k0, k1, grow, pr_out, p_out);
      else if (a.backend == vexp::kVexp)
        tile_p<vexp::kVexp, PER, CSTEP>(sv, m_g, k0, k1, grow, pr_out, p_out);
      else
        tile_p<vexp::kVexpHw, PER, CSTEP>(sv, m_g, k0, k1, grow, pr_out,
                                          p_out);
      if (tt + 1 < t_hi) {
        load_scores(tt + 1);
        cp_async_wait<1>();               // this tile's V; the next's flies
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // warp 0 of slice 0 also chains l, lane g row g (lanes past G read
      // a row that is there and write nothing): a branch the same for
      // the whole warp
      const int c0 = y.c0 - y.k0, c1 = y.c1 - y.k0;
      const __nv_bfloat16* pr = sPr[buf] + warp * RPW;
      const __nv_bfloat16* vc = sV[buf] + 2 * lane;
      if (lwarp)
        chain_tile<true, kMaxG, SC>(acc, lsum, pr, vc,
                                    sP[buf] + lane % kMaxG, c0, c1);
      else
        chain_tile<false, kMaxG, SC>(acc, lsum, pr, vc, nullptr, c0, c1);
      __syncthreads();                    // this buffer's V and p read
      if (tt + 2 < t_hi) {
        load_rows<SC, PAGED, kPvThreads>(
            a, vbase, b, h, page_of<PAGED>(a, b, tt + 2),
            tile_of(a, tt + 2, lo, len), sV[buf], SC, vcols);
        cp_async_commit();
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int g = warp * RPW + i;
      if (g < G)
        *reinterpret_cast<float2*>(a.tpv + ((row0 + g) * a.nB + j) * D +
                                   sl * SC + 2 * lane) =
            make_float2(acc[i][0], acc[i][1]);
    }
    if (lchain) a.tl[(row0 + lane) * a.nB + j] = lsum;
  }
}

// ---- D = 128 at G <= 8, stage 2: one CTA per (update block j, h, b) of
// five warps. Warps 0 .. 3 chain a column a lane (32 w + lane) of R query
// rows (4 at G <= 4, 6 at G 5 and 6, 8 at G 7 and 8), warp 4 each row's l
// (lane g < G, row g), over the block's kept keys in key order from +0.0;
// so every lane of the chains is on a column, each chain step is R FMAs
// fed by 16-byte loads of the key's p (bf16-rounded, held as f32 side by
// side in shared memory, [key][PS] with PS = chain_rows: four a key, or
// eight; at six rows one 16-byte and one 8-byte load) and one bf16 of V,
// and the l chain runs beside the p @ v chains instead of in one of them.
// m_{j-1}, m_j and alpha_j as in split_pv_slice; p of the next tile (warps
// 0 .. 3, PS / 2 (key, row) pairs a thread, rows past G masked to 0)
// beside a tile's chains; the next tiles' V rows in flight (cp.async into
// rows_bufs<PAGED>(tpb) buffers of dynamic shared memory: four on the
// contiguous cache, and where a block is a page as many as it has tiles
// up to four, one at a page of 64 keys), the tile after next's scores in
// registers; one barrier a tile. Writes the block's p @ v, alpha and l
// slots, which combine_blocks chains. One CTA takes all D columns: the
// exps of a block are taken once, not once a column slice.
template <bool PAGED>
__host__ __device__ constexpr int rows_bufs(int tpb) {
  return !PAGED || tpb > kRowsBufs ? kRowsBufs : tpb;
}

template <int D>
__host__ __device__ constexpr size_t rows_smem(int nbuf) {
  return (size_t)nbuf * kTile * D * sizeof(__nv_bfloat16);
}

// the scores' rows a key (chain_rows) of the tier whose stage 2 chains R
// rows, and the keys whose operands its chain loads at once
template <int R>
__host__ __device__ constexpr int rows_stride() {
  return R <= kChainG4 ? kChainG4 : kChainG8;
}

template <int R>
__host__ __device__ constexpr int rows_unroll() {
  return R <= kChainG4 ? kRowsUnroll4 : kRowsUnroll8;
}

// wait until this thread's copies of the current tile have landed, with
// `ahead` (0 .. 3) later tiles' copy groups committed after it
__device__ __forceinline__ void cp_async_wait_ahead(int ahead) {
  if (ahead >= 3)
    cp_async_wait<3>();
  else if (ahead == 2)
    cp_async_wait<2>();
  else if (ahead == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// p = exp(s - m) of a chain thread's PER (key, row) pairs of a tile, as
// tile_p, the bf16-rounded p stored as its f32 value
template <int BK, int PER, int CSTEP, int THREADS>
__device__ __forceinline__ void tile_p_f32(const float (&sv)[PER], float m,
                                           int k0, int k1, bool grow,
                                           float* pr, float* pu) {
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int c = u * CSTEP;
    const float ex = exp_as<BK>(__fsub_rn(sv[u], m));
    const float p = (grow && c >= k0 && c < k1) ? ex : 0.0f;
    pr[u * THREADS] = bf16_round(p);
    pu[u * THREADS] = p;
  }
}

// a lane's R chains (one column) over a tile's kept keys [c0, c1), in key
// order, rows_unroll<R>() keys' operands loaded before their FMAs: pr the
// tile's bf16-rounded p [key][rows_stride<R>()] (f32), vcol the lane's V
// element of key 0, rows D apart (bf16 is the top half of its f32)
template <int D, int R>
__device__ __forceinline__ void chain_col(float (&acc)[R], const float* pr,
                                          const __nv_bfloat16* vcol, int c0,
                                          int c1) {
  static_assert(R == 4 || R == 6 || R == 8, "four, six or eight rows");
  constexpr int PS = rows_stride<R>(), U = rows_unroll<R>();
  auto p_at = [&](int c, float (&p)[R]) {
    const float4 lo = *reinterpret_cast<const float4*>(pr + c * PS);
    p[0] = lo.x; p[1] = lo.y; p[2] = lo.z; p[3] = lo.w;
    if constexpr (R == 6) {
      const float2 hi = *reinterpret_cast<const float2*>(pr + c * PS + 4);
      p[4] = hi.x; p[5] = hi.y;
    } else if constexpr (R == 8) {
      const float4 hi = *reinterpret_cast<const float4*>(pr + c * PS + 4);
      p[4] = hi.x; p[5] = hi.y; p[6] = hi.z; p[7] = hi.w;
    }
  };
  auto v_at = [&](int c) {
    return __uint_as_float((unsigned)__bfloat16_as_ushort(vcol[c * D]) << 16);
  };
  auto key = [&](const float (&p)[R], float v) {
#pragma unroll
    for (int g = 0; g < R; ++g) acc[g] = fmaf(p[g], v, acc[g]);
  };
  int c = c0;
  for (; c + U <= c1; c += U) {
    float p[U][R];
    float v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      p_at(c + k, p[k]);
      v[k] = v_at(c + k);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) key(p[k], v[k]);
  }
  for (; c < c1; ++c) {
    float p[R];
    p_at(c, p);
    key(p, v_at(c));
  }
}

template <int D, bool PAGED, int R, int DV = D>
__global__ void __launch_bounds__(kRowsThreads) split_pv_rows(Args a) {
  constexpr int PS = rows_stride<R>();            // scores' rows a key
  constexpr int CW = kRowsChain / 32;             // chain warps; warp CW: l
  constexpr int PER = PS * kTile / kRowsChain;    // (key, row) pairs a thread
  constexpr int CSTEP = kRowsChain / PS;          // keys between a thread's
  static_assert(D == kRowsChain, "a chain lane takes one column");
  static_assert(kRowsBufs <= 4, "cp_async_wait_ahead takes up to 3 ahead");
  // V tiles [nbuf][key][col]; a compile-time four on the contiguous cache
  const int nbuf = rows_bufs<PAGED>(a.tpb);
  extern __shared__ __align__(16) unsigned char dsmem[];
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(dsmem);
  __shared__ __align__(16) float sPr[2][kTile * PS];   // [key][g], rounded
  __shared__ __align__(16) float sP[2][kTile * PS];    // unrounded
  __shared__ float sM[PS];
  // grid (Hkv, nB, B), the KV heads of a block side by side
  const int j = blockIdx.y, h = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool lwarp = warp == CW;
  const int G = a.G;
  const long long bh = (long long)b * a.Hkv + h, row0 = bh * G;
  // stage 3 may launch now: it waits for this grid before reading its
  // output
  asm volatile("griddepcontrol.launch_dependents;");
  int lo, len;
  kept_range(a, b, lo, len);
  if (!block_live(a, j, lo, len)) return;
  // the block's live tiles [t_lo, t_hi) (its kept keys are contiguous);
  // V is not stage 1's output: the first tiles' copies start now
  const int b0 = j * a.block;
  const int t_lo = j * a.tpb + (max(b0, lo) - b0) / kTile;
  const int t_hi =
      j * a.tpb + (min(min(b0 + a.block, a.S), len) - 1 - b0) / kTile + 1;
  for (int u = 0; u < nbuf && t_lo + u < t_hi; ++u) {
    load_rows<D, PAGED, kRowsThreads>(
        a, a.v, b, h, page_of<PAGED>(a, b, t_lo + u),
        tile_of(a, t_lo + u, lo, len), sV + u * kTile * D, D, DV);
    cp_async_commit();
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int t_mid = j * a.tpb, t_end = t_mid + a.tpb;
  for (int g = warp; g < G; g += CW + 1) {
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
      a.ta[(row0 + g) * a.nB + j] =
          vexp::apply_exp(a.backend, __fsub_rn(before, mx));
    }
  }
  // a chain thread's (key, row) pairs of a tile: row pg, keys c_first +
  // u * CSTEP (scratch index [key][PS] = tid + u * kRowsChain)
  const int pg = tid % PS, c_first = tid / PS;
  const bool grow = !lwarp && pg < G;
  float sv[PER];
  auto load_scores = [&](int tt) {
    const Tile y = tile_of(a, tt, lo, len);
    const float* src = a.scores + (bh * a.nT + tt) * kTile * PS + tid;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int kp = y.k0 + c_first + u * CSTEP;
      sv[u] = (grow && kp >= y.c0 && kp < y.c1) ? src[u * kRowsChain]
                                                : 0.0f;
    }
  };
  load_scores(t_lo);
  __syncthreads();                        // sM
  const float m_g = grow ? sM[pg] : 0.0f;
  // p of tile tt into p buffer (tt - t_lo) & 1, and the next tile's scores
  // into registers (the chain warps)
  auto tile_exps = [&](int tt) {
    const Tile y = tile_of(a, tt, lo, len);
    const int k0 = y.c0 - y.k0 - c_first, k1 = y.c1 - y.k0 - c_first;
    const int buf = (tt - t_lo) & 1;
    float* pr_out = sPr[buf] + tid;
    float* p_out = sP[buf] + tid;
    if (a.backend == vexp::kExact)
      tile_p_f32<vexp::kExact, PER, CSTEP, kRowsChain>(sv, m_g, k0, k1, grow,
                                                       pr_out, p_out);
    else if (a.backend == vexp::kVexp)
      tile_p_f32<vexp::kVexp, PER, CSTEP, kRowsChain>(sv, m_g, k0, k1, grow,
                                                      pr_out, p_out);
    else
      tile_p_f32<vexp::kVexpHw, PER, CSTEP, kRowsChain>(sv, m_g, k0, k1,
                                                        grow, pr_out, p_out);
    if (tt + 1 < t_hi) load_scores(tt + 1);
  };
  if (!lwarp) tile_exps(t_lo);
  float acc[R];
#pragma unroll
  for (int g = 0; g < R; ++g) acc[g] = 0.0f;
  float lsum = 0.0f;
  // one barrier a tile: past it, tile tt's p and V are in shared memory
  // and every thread is done with tile tt - 1, whose V buffer then takes
  // tile tt - 1 + nbuf and whose p buffer tile tt + 1's p, beside tile
  // tt's chains (nbuf >= 2 wherever the block has a second tile)
  for (int tt = t_lo; tt < t_hi; ++tt) {
    const int buf = (tt - t_lo) & 1;
    __nv_bfloat16* vbuf = sV + (tt - t_lo) % nbuf * kTile * D;
    // this tile's V; later tiles' copies fly: nbuf - 1 committed after it
    // at the first tile, nbuf - 2 after (tile tt - 1 + nbuf is not yet)
    cp_async_wait_ahead(min(nbuf - 1 - (tt > t_lo), t_hi - 1 - tt));
    __syncthreads();
    if (tt > t_lo && tt - 1 + nbuf < t_hi) {
      load_rows<D, PAGED, kRowsThreads>(
          a, a.v, b, h, page_of<PAGED>(a, b, tt - 1 + nbuf),
          tile_of(a, tt - 1 + nbuf, lo, len),
          sV + (tt - 1 - t_lo) % nbuf * kTile * D, D, DV);
      cp_async_commit();
    }
    if (!lwarp && tt + 1 < t_hi) tile_exps(tt + 1);
    const Tile y = tile_of(a, tt, lo, len);
    const int c0 = y.c0 - y.k0, c1 = y.c1 - y.k0;
    if (lwarp) {
      // lanes past G read a row that is there and write nothing
      const float* pl = sP[buf] + (lane & (PS - 1));
      for (int c = c0; c < c1; ++c) lsum = __fadd_rn(lsum, pl[c * PS]);
    } else {
      chain_col<D, R>(acc, sPr[buf], vbuf + tid, c0, c1);
    }
  }
  if (lwarp) {
    if (lane < G) a.tl[(row0 + lane) * a.nB + j] = lsum;
  } else {
#pragma unroll
    for (int g = 0; g < R; ++g)
      if (g < G) a.tpv[((row0 + g) * a.nB + j) * D + tid] = acc[g];
  }
}

// The next kernel of the sweep on `stream`, as a programmatic dependent
// launch where `pdl`: its CTAs start while the kernel before drains (stage
// 2's copy their V rows) and wait for it (griddepcontrol.wait) before
// reading its output; without `pdl`, griddepcontrol.wait returns at once.
inline cudaError_t launch_dependent(void (*kernel)(Args), dim3 grid,
                                    int threads, const Args& a,
                                    cudaStream_t stream, bool pdl = true,
                                    size_t smem = 0) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the three kernels of the chained sweep whose scores take MAXG rows a key
// (chain_rows) and, below sixteen, whose stage 2 chains R of them
template <int D, bool PAGED, int MAXG, int R = MAXG, int DV = D>
int launch_chain(Args a, float* scratch, cudaStream_t stream) {
  constexpr bool kRows = MAXG < kChainG;  // stage 2 split_pv_rows
  static_assert(!kRows || rows_stride<R>() == MAXG, "R rows of MAXG");
  const long long tiles = (long long)a.B * a.Hkv * a.G * a.nT;
  const long long blocks = (long long)a.B * a.Hkv * a.G * a.nB;
  a.scores = scratch;                     // MAXG rows a key
  a.tpv = a.scores +                      // 16-byte aligned: float4 reads
          (long long)a.B * a.Hkv * a.nT * kTile * MAXG;
  a.tmax = a.tpv + blocks * D;
  a.ta = a.tmax + tiles;
  a.tl = a.ta + blocks;
  // stage 1's dynamic shared memory (above the 48 KB default) allowed,
  // and as many CTAs per SM as shared memory allows (set once per
  // process)
  static const cudaError_t attrs = [] {
    cudaError_t e = cudaFuncSetAttribute(
        split_scores_rows<D, PAGED, MAXG, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)rows_smem<D, MAXG>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          split_scores_rows<D, PAGED, MAXG, DV>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess) {
      if constexpr (kRows) {
        e = cudaFuncSetAttribute(
            split_pv_rows<D, PAGED, R, DV>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)rows_smem<D>(kRowsBufs));
        if (e == cudaSuccess)
          e = cudaFuncSetAttribute(
              split_pv_rows<D, PAGED, R, DV>,
              cudaFuncAttributePreferredSharedMemoryCarveout,
              (int)cudaSharedmemCarveoutMaxShared);
      } else {
        e = cudaFuncSetAttribute(
            split_pv_slice<D, PAGED, DV>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
      }
    }
    return e;
  }();
  if (attrs != cudaSuccess) return (int)attrs;
  // the dependent launch only where stage 2 has more CTAs than the card
  // has SMs: a smaller grid started early lands its CTAs beside stage
  // 1's, two long block chains to some SMs and none to others, where
  // started after stage 1 it takes one SM a CTA
  // (tools/decode_split_ablation.py)
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  const dim3 grid1(a.nT, a.Hkv, a.B);
  const dim3 grid2 =
      kRows ? dim3(a.Hkv, a.nB, a.B) : dim3(a.nB * slices<D>(), a.Hkv, a.B);
  split_scores_rows<D, PAGED, MAXG, DV>
      <<<grid1, kScoreThreads, rows_smem<D, MAXG>(), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool pdl = (long long)grid2.x * grid2.y * grid2.z > sms;
  if constexpr (kRows)
    err = launch_dependent(split_pv_rows<D, PAGED, R, DV>, grid2, kRowsThreads,
                           a, stream, pdl,
                           rows_smem<D>(rows_bufs<PAGED>(a.tpb)));
  else
    err = launch_dependent(split_pv_slice<D, PAGED, DV>, grid2, kPvThreads, a,
                           stream, pdl);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (long long)a.B * a.Hkv * a.G * (DV / 4);
  return (int)launch_dependent(
      combine_blocks<D, DV>,
      dim3((unsigned)((groups + kPvThreads - 1) / kPvThreads)), kPvThreads,
      a, stream);
}

// Fills the tile geometry and scratch pointers of `a` (whose B, Hkv, G,
// S and block are set) and launches the kernels (two; three where the
// block chains, D = 128 and 256).
// Returns a CUDA error code: invalid arguments, too little scratch, or
// the first launch that failed.
template <int D, int MODE, bool PAGED, int DV = D>
int launch(Args a, float* scratch, long long scratch_len,
           cudaStream_t stream) {
  if (a.G > max_g<D>()) return (int)cudaErrorInvalidValue;
  a.block = max(min(a.block, a.S), 1);
  a.tpb = (a.block + kTile - 1) / kTile;
  a.nB = max((a.S + a.block - 1) / a.block, 1);
  a.nT = a.nB * a.tpb;
  if (scratch_floats(a.B, a.Hkv, a.G, D, a.nT, a.nB) > scratch_len)
    return (int)cudaErrorInvalidValue;
  if constexpr (block_chain<D>()) {
    static_assert(MODE == kNormalized, "a chained D is normalized only");
    if constexpr (D == 128) {
      const int rows = chain_rows(D, a.G);
      if (rows == kChainG4)
        return launch_chain<D, PAGED, kChainG4, kChainG4, DV>(a, scratch,
                                                             stream);
      if (rows == kChainG8)
        return a.G <= kChainG6
                   ? launch_chain<D, PAGED, kChainG8, 6, DV>(a, scratch,
                                                             stream)
                   : launch_chain<D, PAGED, kChainG8, 8, DV>(a, scratch,
                                                             stream);
    }
    return launch_chain<D, PAGED, kChainG, kChainG, DV>(a, scratch, stream);
  } else {
    static_assert(DV == D, "the dense heads hold whole rows");
    const long long tiles = (long long)a.B * a.Hkv * a.G * a.nT;
    a.scores = scratch;
    a.tmax = a.scores + tiles * kTile;
    a.tl = a.tmax + tiles;
    a.ta = a.tl + tiles;
    a.tpv = a.ta + tiles;
    a.tickets = reinterpret_cast<unsigned*>(a.tpv + tiles * D);
    // as many CTAs per SM as shared memory allows (set once per process)
    static const cudaError_t carveout = [] {
      cudaError_t e = cudaFuncSetAttribute(
          split_scores<D, PAGED>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            split_pv<D, MODE, PAGED>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
      return e;
    }();
    if (carveout != cudaSuccess) return (int)carveout;
    const dim3 grid(a.nT, a.Hkv, a.B);
    split_scores<D, PAGED><<<grid, kTile, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_dependent(split_pv<D, MODE, PAGED>, grid, kPvThreads,
                                 a, stream);
  }
}

// `launch` for the head dims the port instantiates (gpt2-small's 64 and
// its --reduced form's 32, in every mode; phi3-medium's 128,
// recurrentgemma's 256 and h2o-danube3's 120, on the D 128 kernels with
// DV = 120, in the normalized mode only: none shards its sequence).
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
    case 120:
      if constexpr (MODE == kNormalized)
        return launch<128, MODE, PAGED, 120>(a, scratch, scratch_len, stream);
      else
        return (int)cudaErrorInvalidValue;
    case 128:
      if constexpr (MODE == kNormalized)
        return launch<128, MODE, PAGED>(a, scratch, scratch_len, stream);
      else
        return (int)cudaErrorInvalidValue;
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
