// FlashAttention-2 forward with the policy's exponential, ragged keys.
//
// Replaces: repro/kernels/flash_attention/kernel.py, flash_attention_bhsd
// (_fa_kernel). Same function: f32 dot products of (q * sm_scale) with k,
// the online (m, l, acc) update once per KV block of `block_k` keys
// counted from key 0, p masked after the exp (a masked lane would
// otherwise add vexp(0) = 1), acc = acc * alpha + p . v, output
// acc * 1/max(l, 1e-30) rounded to bf16. Adds per-row key lengths
// (`kv_len`) and per-row query offsets (`q_offset`: query i of row b sits
// at absolute position q_offset[b] + i, key j at j; causal keep is
// j <= q_offset[b] + i), so ragged serving prefill and suffix prefill
// against a shared-prefix history both run on this kernel.
//
// Bound on this card: bytes. At gpt2-small prefill (D = 64, 512 tokens,
// ragged rows) moving q, o and each row's live K/V once at 3.35 TB/s
// takes 0.0059 ms, longer than the function's multiply-adds at the bf16
// tensor-core rate (chip_smoke.py computes both).
//
// Why the products stay on the CUDA cores. The kernel is held to its
// plain version (the reference's scan in PyTorch f32) per exp backend
// on the share of bf16 outputs whose bits differ: at most 3e-5 under
// exact and vexp, 1e-5 and |err| <= 1e-6 under vexp_hw (ATT_LIMITS in
// kernels/limits.py). Those limits admit only the plain version's own
// summation order: each score a chain of f32 FMAs over d = 0 .. D-1 from
// 0, each p . v a chain over the block's keys in order, as the card's f32
// matrix product sums them. A tensor-core version that reproduces every
// f32 product exactly (q * sm_scale and p split into three bf16 terms;
// K and V are bf16 already) still sums in another order and moves 2-7e-4
// of the outputs by one bf16 ulp, as the plain version computed on the
// host moves 1.2e-4 of them against itself on the card (PERF.md). So the
// products run as those FMA chains, and the design spends itself on
// doing each of them once and on feeding them.
//
// Design: one CTA per (batch, head, 64-query tile), 256 threads; the
// heaviest query tiles of every (batch, head) launch first. The scaled q
// tile sits transposed in shared memory as f32. Per KV block of
// `block_k` keys, K and then V arrive as bf16 64-key sub-tiles through
// cp.async 16-byte copies into a two-stage ring (rows padded by 16 bytes;
// keys past the block, kv_len or the causal bound are zero-filled, never
// read), so the next sub-tile is in flight while one computes; each is
// widened once into an f32 tile (K transposed). Every thread holds a
// 4 x 4 patch: 4 query rows by 4 keys (tx, tx + 16, tx + 32, tx + 48 of
// the sub-tile) for the scores, by D/16 output columns for p . v. The
// block's scores are computed once, into a shared f32 score tile of up
// to block_k keys, and the row max is taken when the block's last K
// sub-tile is done; then p = exp(s - m_new), masked, overwrites each
// score, and p . v runs into a fresh f32 patch per block. Only then,
// once per block, l = l * alpha + sum(p) and acc = acc * alpha + pv with
// rounded f32 operations, as the reference does; sub-tiling inside a
// block is free, a second (m, l) update would not be. KV blocks and
// sub-tiles past the causal bound, past kv_len or below the window are
// skipped: for their rows they would be an exact no-op (alpha = exp(0) =
// 1, p = 0). Dynamic shared memory is 53 KB plus 256 bytes per key of
// the score tile at D = 64 (181 KB at block_k = 512: one CTA per SM; two
// at block_k = 128), so block_k is bounded by it: 640 keys at D = 64 on
// an H100. The shared-memory limit is raised once per instantiation and
// device.
//
// Head dims 128 (phi3-medium: 4 query heads a KV head) and 256
// (recurrentgemma: 16 query heads on one KV head) have a kernel of their
// own, fa_rows below, templated on the head dim and built for this
// card's CUDA cores (h2o-danube3's head dim 120 runs the D 128 kernel
// with columns 120-127 of q, K and V zero-filled as they load, so each
// score's chain ends in exact +0 terms, and 120 columns written): the
// function's f32 FMA chains run at most at one FMA a clock on each of an
// SM's 128 lanes, so the design spends itself on how many FMAs each
// shared-memory load and each issued instruction feeds.
// - A CTA of 256 threads takes 64 query rows of one KV head, rows being
//   (position, query head) pairs, position-major: at G 16 four positions
//   of all 16 heads, at G 4 sixteen positions of 4 heads, which share
//   every key and so the causal bound.
// - Each thread holds 8 rows of a register tile in both phases: 8 rows by
//   8 keys for the scores, 8 rows by D / 32 output columns for p . v (8
//   at D 256, 4 at D 128); rows 4 tr + i and 32 + 4 tr + i (tr = lane %
//   8), the same in both phases.
// - K arrives in 16-d slabs of 256 keys (16 KB) and V in slabs of all D
//   columns that fill a 16 KB stage (16 keys at D 256; at D 128 a whole
//   32-key group, so p . v takes one barrier and one V copy a group),
//   through the thread's registers: loaded as bf16 while the slab before
//   computes, widened once to f32 and stored into a two-stage ring, so
//   the inner loops issue FMAs and shared loads only (90-94 % FMAs at D
//   256; the score slab's loop 93 % at D 128, from its SASS). A block's
//   live keys go in 32-key groups, one group a warp; where four or fewer
//   (or two or fewer) are left, two (or four) warps share a group at 4
//   (or 2) rows a thread, and 5 or 6 left run as 4 and the rest, so that
//   few warps idle.
// - The block's scores go to a shared f32 score tile, key-major, 64 rows
//   a key; the block max, then p = exp(s - m_new) written over them, one
//   key a thread a group, a group ahead of the p . v that reads it.
// - A block's l is one chain over its keys in order, folded into the
//   p . v loop: row warp of each thread's eight, whose running m and l
//   that thread keeps; the lanes tc = 0 publish m_new and alpha.
// - The tiles of a batch row launch from the last position down, so
//   that under a causal mask heavy CTAs start first.
// Shared memory: the f32 q^T tile (D x 256 bytes: 64 KB at D 256, 32 at
// 128), the f32 ring (32 KB), 2.8 KB of row state, and the score tile,
// 256 bytes a key: 227 KB at block_k = 512 at D 256 and 195 KB at D 128,
// where the card admits block_k up to 640; one CTA per SM. What holds
// the function is unchanged from the reference's scan: q * sm_scale
// rounded first, each score one FMA chain over d = 0 .. D - 1, the online
// update once per block_k keys from key 0, p masked after the exp, each
// p . v and each l one chain over the block's keys in order (l as the
// plain version's product of p with ones sums it), l = l alpha + sum and
// acc = acc alpha + pv rounded, the output acc / max(l, 1e-30). D = 32
// and 64 keep their tiling and their sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vexp.cuh"

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr float kNegInf = -1e30f;

// The tiling of head dim D = 32 and 64: 64 query rows by 64-key
// sub-tiles, two CTAs per SM. D = 128 and 256 have a kernel of their own
// (fa_rows).
template <int D>
struct Tile {
  static constexpr int kBQ = 64;                // query rows per CTA
  static constexpr int kTK = 64;                // keys per sub-tile
  static constexpr int kMinBlocks = 2;
  static constexpr int kTY = kBQ / 4;           // row groups of 4 rows
  static constexpr int kTX = kThreads / kTY;    // threads per row group
  static constexpr int kKW = kTK / kTX;         // keys per thread: tx +
                                                // kTX j
  static constexpr int kLanesX = kTX / 2;       // tx in one warp; two
                                                // warps share a row group
  static constexpr int kLdQ = kBQ + 4;  // f32 row of q^T (per d)
  static constexpr int kLdS = kBQ;      // f32 row of the score tile
  static constexpr int kLdK = kTK + 4;  // f32 row of K^T (per d)
};

// A key's row of the score tile holds its kTY 16-byte chunks (4 rows
// each) in an order XORed with the key, so that eight neighbouring keys
// at one row group fall in eight different bank groups.
template <int D>
__device__ __forceinline__ int sidx(int key, int ty) {
  return key * Tile<D>::kLdS + 4 * (ty ^ (key & 7));
}

struct Strides {               // element strides; the last dim is packed
  long long b, h, s;
};

// Shared-memory layout, in bytes from the start, per head dim D; the
// score tile, last, holds `nk` keys.
template <int D>
struct Smem {
  using T = Tile<D>;
  static constexpr int kRowB = D + 8;            // bf16 ring row: eight
                                                 // rows at one column
                                                 // hit eight bank groups
  static constexpr int kStage = T::kTK * kRowB;  // one ring stage, elements
  static constexpr int kLdV = D + 4;             // f32 V row
  static constexpr int kTile = D * T::kLdK > T::kTK * kLdV
                                   ? D * T::kLdK : T::kTK * kLdV;
  static constexpr size_t ring = 0;              // [2][kTK][kRowB]
  static constexpr size_t q_t = ring + 2 * kStage * sizeof(__nv_bfloat16);
  static constexpr size_t tile = q_t + (size_t)D * T::kLdQ * sizeof(float);
  static constexpr size_t red = tile + (size_t)kTile * sizeof(float);
  static constexpr size_t s = red + 2 * 2 * T::kBQ * sizeof(float);
  static size_t bytes(int nk) {
    return s + (size_t)nk * T::kLdS * sizeof(float);
  }
};

// keys the score tile holds for a block of `block_k`: whole sub-tiles
template <int D>
inline int score_keys(int block_k) {
  constexpr int TK = Tile<D>::kTK;
  return (block_k + TK - 1) / TK * TK;
}

__device__ __forceinline__ bool keep_key(int kp, int qp, int kmax,
                                         int causal, int window) {
  return kp < kmax && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Where a CTA is in its sweep: KV block, pass (0: K and the scores, 1: V
// and p . v) and sub-tile j of the block's live sub-tiles [j0, j1).
struct Item {
  int blk, pass, j, j0, j1;
};

// A query tile's walk over its KV blocks, counted from key 0 in units of
// block_k: blocks past the causal bound, past kv_len or below the window
// are skipped, and so are the sub-tiles of a block that lie wholly
// outside [kstart, kend). Each live block is walked twice, pass 0 then
// pass 1, over the same sub-tiles.
template <int D>
struct Sweep {
  static constexpr int kBQ = Tile<D>::kBQ, kTK = Tile<D>::kTK;
  int block_k, kstart, kend, blk_end;

  __device__ Sweep(int klen, int qa0, int causal, int window, int bk)
      : block_k(bk) {
    kend = causal ? min(klen, qa0 + kBQ) : klen;   // exclusive
    kstart = window > 0 ? max(0, qa0 - window + 1) : 0;
    blk_end = (kend + block_k - 1) / block_k;
  }
  // keys of block blk that may be live: [blk * block_k, kmax)
  __device__ int kmax(int blk) const {
    return min(blk * block_k + block_k, kend);
  }
  __device__ int key0(const Item& it) const {
    return it.blk * block_k + it.j * kTK;
  }
  __device__ bool first_from(Item& it, int blk) const {
    for (; blk < blk_end; ++blk) {
      const int k0 = blk * block_k, km = kmax(blk);
      it.j0 = kstart > k0 ? (kstart - k0) / kTK : 0;
      it.j1 = km > k0 ? (km - k0 + kTK - 1) / kTK : 0;
      if (it.j0 < it.j1) {
        it.blk = blk;
        it.pass = 0;
        it.j = it.j0;
        return true;
      }
    }
    return false;
  }
  __device__ bool first(Item& it) const {
    return first_from(it, kstart / block_k);
  }
  __device__ bool advance(Item& it) const {
    if (++it.j < it.j1) return true;
    if (it.pass == 0) {
      it.pass = 1;
      it.j = it.j0;
      return true;
    }
    return first_from(it, it.blk + 1);
  }
  // whether every key of sub-tile j of block blk is kept for every row
  // of the tile (rows at absolute positions qa0 .. qa0 + kBQ - 1)
  __device__ bool interior(int blk, int j, int qa0, int causal,
                           int window) const {
    const int k0 = blk * block_k + j * kTK;
    return k0 + kTK <= kmax(blk) && (!causal || k0 + kTK - 1 <= qa0) &&
           (window <= 0 || k0 > qa0 + kBQ - 1 - window);
  }
};

// The item's sub-tile (K in pass 0, V in pass 1) into ring stage `stage`;
// rows at or past the block's kmax are zero-filled.
template <int D>
__device__ __forceinline__ void issue(__nv_bfloat16* ring, int stage,
                                      const Sweep<D>& sw, const Item& it,
                                      const __nv_bfloat16* kb, long long kss,
                                      const __nv_bfloat16* vb,
                                      long long vss) {
  constexpr int CH = D / 8;                    // 16-byte chunks per row
  constexpr int kTK = Tile<D>::kTK;
  __nv_bfloat16* dst = ring + stage * Smem<D>::kStage;
  const __nv_bfloat16* src = it.pass == 0 ? kb : vb;
  const long long stride = it.pass == 0 ? kss : vss;
  const int km = sw.kmax(it.blk), k0 = sw.key0(it);
#pragma unroll
  for (int n = 0; n < kTK * CH / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / CH, c = i % CH;
    const int key = k0 + r;
    const bool ok = key < km;
    cp_async16(dst + r * Smem<D>::kRowB + c * 8,
               ok ? src + key * stride + c * 8 : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void widen8(uint4 w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// K sub-tile (bf16 rows) -> K^T f32, d-major; key r = kTX j + t sits at
// column kKW t + j, so thread tx reads its keys tx + kTX j in one load
template <int D>
__device__ __forceinline__ void widen_k(const __nv_bfloat16* ring,
                                        float* kt) {
  constexpr int CH = D / 8;
  constexpr int kTK = Tile<D>::kTK, kTX = Tile<D>::kTX, kKW = Tile<D>::kKW,
                kLdK = Tile<D>::kLdK;
#pragma unroll
  for (int n = 0; n < kTK * CH / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i % kTK, c = i / kTK;        // neighbours: next key
    float f[8];
    widen8(*reinterpret_cast<const uint4*>(ring + r * Smem<D>::kRowB +
                                           c * 8), f);
    const int col = kKW * (r % kTX) + r / kTX;
#pragma unroll
    for (int e = 0; e < 8; ++e) kt[(c * 8 + e) * kLdK + col] = f[e];
  }
}

// V sub-tile (bf16 rows) -> V f32, key-major
template <int D>
__device__ __forceinline__ void widen_v(const __nv_bfloat16* ring,
                                        float* vf) {
  constexpr int CH = D / 8;
  constexpr int kTK = Tile<D>::kTK;
#pragma unroll
  for (int n = 0; n < kTK * CH / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / CH, c = i % CH;
    float f[8];
    widen8(*reinterpret_cast<const uint4*>(ring + r * Smem<D>::kRowB +
                                           c * 8), f);
    float4* dst = reinterpret_cast<float4*>(vf + r * Smem<D>::kLdV + c * 8);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// N consecutive f32 of shared memory (N = 1, 2 or a multiple of 4), in
// as few loads as their alignment allows
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + u);
      v[u] = t.x; v[u + 1] = t.y; v[u + 2] = t.z; v[u + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// The scores of one K sub-tile for the thread's 4 rows and its keys
// tx + kTX j: one FMA chain per score over d. Each goes to the score tile
// at `slot` (key-major), and the kept ones into the row maxima mx.
template <int D>
__device__ __forceinline__ void score_tile(const float* sQt, const float* sKt,
                                           float* slot, int tx, int ty,
                                           int key0, int kmax, int qa,
                                           bool inner, int causal,
                                           int window, float (&mx)[4]) {
  constexpr int kKW = Tile<D>::kKW, kTX = Tile<D>::kTX,
                kLdQ = Tile<D>::kLdQ, kLdK = Tile<D>::kLdK;
  float s[4][kKW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kKW; ++j) s[i][j] = 0.0f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    float qr[4], kr[kKW];
    load_f32<4>(sQt + d * kLdQ + 4 * ty, qr);
    load_f32<kKW>(sKt + d * kLdK + kKW * tx, kr);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kKW; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
  }
#pragma unroll
  for (int j = 0; j < kKW; ++j) {
    const int kk = tx + kTX * j;               // key within the sub-tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (inner || keep_key(key0 + kk, qa + i, kmax, causal, window))
        mx[i] = fmaxf(mx[i], s[i][j]);
    *reinterpret_cast<float4*>(slot + sidx<D>(kk, ty)) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
  }
}

// p = exp(s - m_new), masked, from the thread's own scores at `sl` (the
// sub-tile from key key0), written over them, and their sum into rsum
template <int D, int BACKEND>
__device__ __forceinline__ void make_p(float* sl, int key0, bool inner,
                                       int kmax, int qa, int causal,
                                       int window, int tx, int ty,
                                       const float (&m_new)[4],
                                       float (&rsum)[4]) {
  constexpr int kKW = Tile<D>::kKW, kTX = Tile<D>::kTX;
#pragma unroll
  for (int j = 0; j < kKW; ++j) {
    float4* at = reinterpret_cast<float4*>(sl + sidx<D>(tx + kTX * j, ty));
    const float4 sv = *at;
    const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ex = vexp::apply_exp(BACKEND, __fsub_rn(sr[i], m_new[i]));
      p[i] = inner || keep_key(key0 + tx + kTX * j, qa + i, kmax, causal,
                               window) ? ex : 0.0f;
      rsum[i] = __fadd_rn(rsum[i], p[i]);
    }
    *at = make_float4(p[0], p[1], p[2], p[3]);
  }
}

template <int D, int BACKEND>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
fa_fwd_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, const int* __restrict__ kv_len,
              const int* __restrict__ q_offset, int q_off, int H, int Hkv,
              int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
              float sm_scale, int causal, int window, int block_k) {
  using L = Smem<D>;
  using T = Tile<D>;
  constexpr int kBQ = T::kBQ, kTK = T::kTK, kTX = T::kTX,
                kLanesX = T::kLanesX, kLdQ = T::kLdQ, kLdS = T::kLdS;
  constexpr int CW = D / kTX;              // p . v columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + L::ring);
  float* sQt = reinterpret_cast<float*>(smem + L::q_t);   // D x kLdQ
  float* sT = reinterpret_cast<float*>(smem + L::tile);   // K^T or V
  float* sMax = reinterpret_cast<float*>(smem + L::red);  // [2][kBQ]
  float* sSum = sMax + 2 * kBQ;                           // [2][kBQ]
  float* sS = reinterpret_cast<float*>(smem + L::s);      // nk x kLdS

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // heavy tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int half = warp % 2;                  // which half of the tx
  const int tx = lane % kLanesX + kLanesX * half;   // keys tx + kTX j;
                                                    // columns CW tx ..
  const int ty = lane / kLanesX + 32 / kLanesX * (warp / 2);   // rows
                                                    // 4 ty .. 4 ty + 3

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  const int klen = kv_len != nullptr ? min(kv_len[b], Sk) : Sk;
  const int qoff = q_offset != nullptr ? q_offset[b] : q_off;
  const int qa0 = qoff + q0;                      // absolute pos of row 0
  const int qa = qa0 + 4 * ty;                    // ... of the thread's
  const Sweep<D> sw(klen, qa0, causal, window, block_k);

  Item cur;
  bool live = sw.first(cur);
  if (live) issue<D>(ring, 0, sw, cur, kb, ks.s, vb, vs.s);
  cp_async_commit();

  // q * sm_scale, transposed: sQt[d][r]; every 16-byte load is in flight
  // before the first is used
  {
    constexpr int CH = D / 8, N = (kBQ * CH + kThreads - 1) / kThreads;
    uint4 w[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = tid + n * kThreads, r = i / CH, c = i % CH;
      w[n] = i < kBQ * CH && q0 + r < Sq
                 ? *reinterpret_cast<const uint4*>(qb + (q0 + r) * qs.s +
                                                   c * 8)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = tid + n * kThreads, r = i / CH, c = i % CH;
      if (i >= kBQ * CH) break;
      float f[8];
      widen8(w[n], f);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sQt[(c * 8 + e) * kLdQ + r] = __fmul_rn(f[e], sm_scale);
    }
  }

  // per row i of the thread's four: running (m, l, acc); per block: the
  // thread's part of the row max and of the p sum, (m_new, alpha), p . v
  float m_run[4], l_run[4], acc[4][CW], pv[4][CW];
  float mx[4], m_new[4], alpha[4], rsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = m_new[i] = mx[i] = kNegInf;
    l_run[i] = rsum[i] = 0.0f;
    alpha[i] = 1.0f;
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = pv[i][j] = 0.0f;
  }

  int stage = 0;
  while (live) {
    Item nxt = cur;
    const bool more = sw.advance(nxt);
    if (more) issue<D>(ring, stage ^ 1, sw, nxt, kb, ks.s, vb, vs.s);
    cp_async_commit();
    cp_async_wait_one();             // the current stage has landed
    __syncthreads();                 // ... for every thread; the f32
                                     // tile of the last item is free
    const __nv_bfloat16* rt = ring + stage * L::kStage;
    float* slot = sS + (cur.j - cur.j0) * kTK * kLdS;   // the sub-tile's
                                                        // keys, p^T rows
    if (cur.pass == 0) {
      widen_k<D>(rt, sT);
      __syncthreads();
      // ---- scores, into the score tile and the row maxima
      if (cur.j == cur.j0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i] = kNegInf;
      }
      const int kmax = sw.kmax(cur.blk);
      score_tile<D>(sQt, sT, slot, tx, ty, sw.key0(cur), kmax, qa,
                    sw.interior(cur.blk, cur.j, qa0, causal, window), causal,
                    window, mx);
      if (cur.j + 1 == cur.j1) {
        // ---- the block's row max: the 8 lanes of a row group, then the
        // two warps that share its rows
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float m = mx[i];
#pragma unroll
          for (int x = 1; x < kLanesX; x *= 2)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, x));
          if (lane % kLanesX == 0) sMax[half * kBQ + 4 * ty + i] = m;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float m = fmaxf(sMax[4 * ty + i], sMax[kBQ + 4 * ty + i]);
          m_new[i] = fmaxf(m_run[i], m);
          alpha[i] = vexp::apply_exp(BACKEND, __fsub_rn(m_run[i], m_new[i]));
          rsum[i] = 0.0f;
#pragma unroll
          for (int j = 0; j < CW; ++j) pv[i][j] = 0.0f;
        }
        // ---- p = exp(s - m_new), masked, over the thread's own scores
        for (int jj = cur.j0; jj < cur.j1; ++jj)
          make_p<D, BACKEND>(sS + (jj - cur.j0) * kTK * kLdS,
                          cur.blk * block_k + jj * kTK,
                          sw.interior(cur.blk, jj, qa0, causal, window), kmax,
                          qa, causal, window, tx, ty, m_new, rsum);
      }
    } else {
      widen_v<D>(rt, sT);
      __syncthreads();               // V and every thread's p
      // ---- pv += p . v, one FMA chain per output over the keys in order
#pragma unroll 16
      for (int c = 0; c < kTK; ++c) {
        float pr[4], vr[CW];
        load_f32<4>(slot + sidx<D>(c, ty), pr);
        load_f32<CW>(sT + c * L::kLdV + CW * tx, vr);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CW; ++j) pv[i][j] = fmaf(pr[i], vr[j], pv[i][j]);
      }
      if (cur.j + 1 == cur.j1) {
        // ---- the block's one online update
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sum = rsum[i];
#pragma unroll
          for (int x = 1; x < kLanesX; x *= 2)
            sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, x));
          if (lane % kLanesX == 0) sSum[half * kBQ + 4 * ty + i] = sum;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sum = __fadd_rn(sSum[4 * ty + i],
                                      sSum[kBQ + 4 * ty + i]);
          l_run[i] = __fadd_rn(__fmul_rn(l_run[i], alpha[i]), sum);
          m_run[i] = m_new[i];
#pragma unroll
          for (int j = 0; j < CW; ++j)
            acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], alpha[i]), pv[i][j]);
        }
      }
    }
    if (!more) break;
    cur = nxt;
    stage ^= 1;
  }

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float inv = 1.0f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CW; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * os.s + CW * tx + j) =
          __floats2bfloat162_rn(__fmul_rn(acc[i][j], inv),
                                __fmul_rn(acc[i][j + 1], inv));
  }
}

// ------------------------------------------------------- D = 128 and 256
//
// fa_rows_kernel: see the head of this file.
namespace fa_rows {

constexpr int kRows = 64;              // query rows of a CTA
constexpr int kGroup = 32;             // keys of a group: a warp's keys in
                                       // the score phase
constexpr int kSubGroups = 8;          // groups of a K piece (256 keys)
constexpr int kSlabD = 16;             // d of one K slab
constexpr int kStage = kSubGroups * kGroup * kSlabD;   // f32 of a stage:
                                       // a K slab [256][16] or a V slab
                                       // [16][kD]

// Shared memory of head dim kD, in bytes from the start; the score tile,
// last, holds the block's keys rounded up to whole groups. kCols: the
// p . v columns of a thread (8 rows by kCols columns). kVKeys: the keys of
// one V slab, as many as fill a stage: 16 at D 256, a whole 32-key group
// at D 128, so that D 128 takes one barrier and one V copy a group.
template <int kD>
struct Layout {
  static_assert(kD == 128 || kD == 256, "fa_rows takes head dim 128, 256");
  static constexpr int kVKeys = kStage / kD;
  static_assert(kGroup % kVKeys == 0, "a group is whole V slabs");
  static constexpr int kCols = kD / 32;
  static constexpr size_t kQt = 0;                           // f32 [kD][64]
  static constexpr size_t kRing = kQt + (size_t)kD * kRows * 4;  // [2][kStg]
  static constexpr size_t kMax = kRing + 2 * (size_t)kStage * 4; // [8][64]
  static constexpr size_t kMn = kMax + 8 * kRows * 4;        // f32 [64]
  static constexpr size_t kA = kMn + kRows * 4;              // f32 [64]
  static constexpr size_t kQp = kA + kRows * 4;              // int [64]
  static constexpr size_t kS = kQp + kRows * 4;              // f32 [nk][64]
};

template <int kD>
inline size_t smem_bytes(int block_k) {
  return Layout<kD>::kS +
         (size_t)(block_k + kGroup - 1) / kGroup * kGroup * kRows * 4;
}

// The KV blocks of one CTA, counted from key 0 in units of block_k: a
// block is live where it holds a key in [kstart, kend), and its live
// groups are the 32-key groups, counted from the block's start, that
// hold one.
struct Walk {
  int bk, kstart, kend, blk_end;
  __device__ bool live(int blk, int& g_lo, int& g_hi) const {
    const int k0 = blk * bk;
    const int lo = max(kstart, k0), hi = min(k0 + bk, kend);
    g_lo = (lo - k0) / kGroup;
    g_hi = (hi - k0 + kGroup - 1) / kGroup;
    return lo < hi;
  }
  // the first live block at or after blk, or blk_end
  __device__ int next_live(int blk) const {
    int g_lo, g_hi;
    while (blk < blk_end && !live(blk, g_lo, g_hi)) ++blk;
    return blk;
  }
  __device__ int kmax(int blk) const { return min(blk * bk + bk, kend); }
};

// The groups of the next score piece when `rem` are left: 8 (a warp a
// group, 8 rows a thread); 4 for 5 or 6, so that the rest takes a piece
// of two warps or four warps a group (4 or 2 rows a thread) instead of
// idle warps; else all.
__device__ __forceinline__ int piece(int rem) {
  return rem >= kSubGroups ? kSubGroups : rem == 5 || rem == 6 ? 4 : rem;
}

// One stage's bf16 through the thread's registers: loaded from global
// memory while the stage before it computes, widened to f32 and stored
// after. Keys at or past km load as zeros; K rows past the piece's keys
// are neither loaded nor stored.
struct Staged {
  uint4 w[2];
};

// Whether the kernel of head dim kD also serves a narrower head dim dv,
// zero-filling the rest of each q, K and V row as it loads them: D 128
// serves h2o-danube3's 120 (an exact +0 at the end of each score's
// chain; dv columns written). Elsewhere that code folds away.
template <int kD>
constexpr bool kNarrow = kD == 128;

// K slab sl (d 16 sl .. 16 sl + 15) of the nkeys keys from key0:
// [key][16 d]; thread tid takes key tid / 2 (+ 128), half tid % 2. Columns
// at or past dv (the head dim the tensors hold) load as zeros.
template <int kD>
__device__ __forceinline__ void load_k(Staged& st, const __nv_bfloat16* kb,
                                       long long kss, int key0, int nkeys,
                                       int km, int sl, int dv) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int r = threadIdx.x / 2 + n * (kThreads / 2), h = threadIdx.x % 2;
    const int key = key0 + r;
    st.w[n] = r < nkeys && key < km &&
                      (!kNarrow<kD> || kSlabD * sl + 8 * h < dv)
                  ? *reinterpret_cast<const uint4*>(kb + key * kss +
                                                    kSlabD * sl + 8 * h)
                  : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void store_k(float* stage, const Staged& st,
                                        int nkeys) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int r = threadIdx.x / 2 + n * (kThreads / 2), h = threadIdx.x % 2;
    if (r >= nkeys) break;
    float f[8];
    widen8(st.w[n], f);
    float4* at = reinterpret_cast<float4*>(stage + r * kSlabD + 8 * h);
    at[0] = make_float4(f[0], f[1], f[2], f[3]);
    at[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// V slab: 16 keys from key0, all kD d, [key][kD]; 16 bytes a thread at
// kD = 128, 32 at 256; columns at or past dv load as zeros
template <int kD>
__device__ __forceinline__ void load_v(Staged& st, const __nv_bfloat16* vb,
                                       long long vss, int key0, int km,
                                       int dv) {
#pragma unroll
  for (int n = 0; n < Layout<kD>::kVKeys * kD / 8 / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / (kD / 8), c = i % (kD / 8);
    const int key = key0 + r;
    st.w[n] = key < km && (!kNarrow<kD> || 8 * c < dv)
                  ? *reinterpret_cast<const uint4*>(vb + key * vss + 8 * c)
                  : make_uint4(0, 0, 0, 0);
  }
}

template <int kD>
__device__ __forceinline__ void store_v(float* stage, const Staged& st) {
#pragma unroll
  for (int n = 0; n < Layout<kD>::kVKeys * kD / 8 / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / (kD / 8), c = i % (kD / 8);
    float f[8];
    widen8(st.w[n], f);
    float4* at = reinterpret_cast<float4*>(stage + r * kD + 8 * c);
    at[0] = make_float4(f[0], f[1], f[2], f[3]);
    at[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// The positions of the thread's eight rows (4 tr + i, 32 + 4 tr + i)
__device__ __forceinline__ void row_positions(const int* sQp, int tr,
                                              int (&qp)[8]) {
  const int4 a = *reinterpret_cast<const int4*>(sQp + 4 * tr);
  const int4 c = *reinterpret_cast<const int4*>(sQp + 32 + 4 * tr);
  qp[0] = a.x; qp[1] = a.y; qp[2] = a.z; qp[3] = a.w;
  qp[4] = c.x; qp[5] = c.y; qp[6] = c.z; qp[7] = c.w;
}

// One K slab of the scores: s[i][j] = fma(q[row i][d], k[key j][d],
// s[i][j]) for d = 16 sl .. 16 sl + 15 in order. qt: q^T at this slab's
// first d and the thread's first row; ks: the slab's row of the thread's
// first key (keys tc + 4 j of the warp's group). R = 8: rows 4 tr + i and
// 32 + 4 tr + i; R = 4 or 2: R consecutive rows from qt's.
template <int R>
__device__ __forceinline__ void score_slab(const float* qt, const float* ks,
                                           float (&s)[8][8]) {
#pragma unroll 2
  for (int d4 = 0; d4 < kSlabD / 4; ++d4) {
    float kr[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      load_f32<4>(ks + 4 * j * kSlabD + 4 * d4, kr[j]);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float* qd = qt + (4 * d4 + dd) * kRows;
      float q[8];
      load_f32<R < 4 ? R : 4>(qd, q);
      if constexpr (R == 8) load_f32<4>(qd + 32, q + 4);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(q[i], kr[j][dd], s[i][j]);
    }
  }
}

// A piece's scores of group g (keys tc + 4 j) into the score tile
// (key-major, 64 rows a key), and the kept ones into the row maxima. R =
// 8: the thread's eight rows; R = 4 or 2: its rows H R .. H R + R - 1
// (rows 32 (H R / 4) + 4 tr + H R % 4 + i).
template <int R, int H>
__device__ __forceinline__ void keep_scores(float* sS, const float (&s)[8][8],
                                            int g, int tr, int tc, bool in,
                                            int k0, int km,
                                            const int (&qp)[8], int causal,
                                            int window, float (&mx)[8]) {
  constexpr int base = R == 8 ? 0 : R * H;
  constexpr int off = base / 4 * 32 + base % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int kk = g * kGroup + tc + 4 * j;     // key in the block
    float* at = sS + kk * kRows + off + 4 * tr;
    if constexpr (R == 2) {
      *reinterpret_cast<float2*>(at) = make_float2(s[0][j], s[1][j]);
    } else {
      *reinterpret_cast<float4*>(at) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      if constexpr (R == 8)
        *reinterpret_cast<float4*>(at + 32) =
            make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (in || keep_key(k0 + kk, qp[base + i], km, causal, window))
        mx[base + i] = fmaxf(mx[base + i], s[i][j]);
  }
}

// keep_scores for the warp's part of the rows (R = 4: two parts, R = 2:
// four)
template <int R>
__device__ __forceinline__ void keep_part(int part, float* sS,
                                          const float (&s)[8][8], int g,
                                          int tr, int tc, bool in, int k0,
                                          int km, const int (&qp)[8],
                                          int causal, int window,
                                          float (&mx)[8]) {
  if (part == 0)
    keep_scores<R, 0>(sS, s, g, tr, tc, in, k0, km, qp, causal, window, mx);
  else if (part == 1)
    keep_scores<R, 1>(sS, s, g, tr, tc, in, k0, km, qp, causal, window, mx);
  if constexpr (R == 2) {
    if (part == 2)
      keep_scores<2, 2>(sS, s, g, tr, tc, in, k0, km, qp, causal, window, mx);
    else if (part == 3)
      keep_scores<2, 3>(sS, s, g, tr, tc, in, k0, km, qp, causal, window, mx);
  }
}

// p = exp(s - m_new), masked, over the thread's eight rows at key
// 4 warp + tc of group g, written over their scores; m_new from sMn
template <int BACKEND>
__device__ __forceinline__ void p_group(float* sS, int g, int tr, int tc,
                                        int warp, bool in, int k0, int km,
                                        const int* sQp, const float* sMn,
                                        int causal, int window) {
  const int kk = g * kGroup + 4 * warp + tc;
#pragma unroll
  for (int h = 0; h < 2; ++h) {                  // rows 32 h + 4 tr + i
    float4* at = reinterpret_cast<float4*>(sS + kk * kRows + 32 * h + 4 * tr);
    const float4 x = *at;
    const float4 mn = *reinterpret_cast<const float4*>(sMn + 32 * h + 4 * tr);
    const float sv[4] = {x.x, x.y, x.z, x.w}, m[4] = {mn.x, mn.y, mn.z, mn.w};
    int qp[4] = {0, 0, 0, 0};
    if (!in) {
      const int4 a = *reinterpret_cast<const int4*>(sQp + 32 * h + 4 * tr);
      qp[0] = a.x; qp[1] = a.y; qp[2] = a.z; qp[3] = a.w;
    }
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ex = vexp::apply_exp(BACKEND, __fsub_rn(sv[i], m[i]));
      p[i] = in || keep_key(k0 + kk, qp[i], km, causal, window) ? ex : 0.0f;
    }
    *at = make_float4(p[0], p[1], p[2], p[3]);
  }
}

// One V slab of p . v: pv[i][j] = fma(p[row i][c], v[c][col j], pv[i][j])
// for the slab's 16 keys c in order, and the l chain of row lrow:
// lch = lch + p[lrow][c]. sp: the score tile at the slab's first key;
// vs: the V slab at the thread's first column (C columns a thread).
template <int kD, int C = Layout<kD>::kCols>
__device__ __forceinline__ void pv_slab(const float* sp, const float* vs,
                                        int tr, int lrow, float (&pv)[8][C],
                                        float& lch) {
#pragma unroll
  for (int c = 0; c < Layout<kD>::kVKeys; ++c) {
    float p[8], v[C];
    load_f32<4>(sp + c * kRows + 4 * tr, p);
    load_f32<4>(sp + c * kRows + 32 + 4 * tr, p + 4);
    load_f32<C>(vs + c * kD, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) pv[i][j] = fmaf(p[i], v[j], pv[i][j]);
    lch = __fadd_rn(lch, sp[c * kRows + lrow]);
  }
}

// dv: the head dim of the tensors, kD or (where kNarrow) fewer columns
template <int kD, int BACKEND>
__global__ void __launch_bounds__(kThreads, 1)
fa_rows_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, const int* __restrict__ kv_len,
               const int* __restrict__ q_offset, int q_off, int H, int Hkv,
               int Sq, int Sk, Strides qs, Strides ks, Strides vs,
               Strides os, float sm_scale, int causal, int window,
               int block_k, int dv) {
  using L = Layout<kD>;
  constexpr int C = L::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQt = reinterpret_cast<float*>(smem + L::kQt);
  float* ring = reinterpret_cast<float*>(smem + L::kRing);  // [2][kStage]
  float* sMax = reinterpret_cast<float*>(smem + L::kMax);   // [warp][row]
  float* sMn = reinterpret_cast<float*>(smem + L::kMn);   // the block's m_new
  float* sA = reinterpret_cast<float*>(smem + L::kA);     // and alpha a row
  int* sQp = reinterpret_cast<int*>(smem + L::kQp);       // row positions
  float* sS = reinterpret_cast<float*>(smem + L::kS);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tr = lane % 8, tc = lane / 8;
  const int G = H / Hkv, nrows = Sq * G;
  const int ntiles = (nrows + kRows - 1) / kRows;
  const int per_b = Hkv * ntiles;
  const int b = blockIdx.x / per_b, rem = blockIdx.x % per_b;
  const int hk = rem / ntiles;
  const int r0 = (ntiles - 1 - rem % ntiles) * kRows;   // heavy tiles first
  const int klen = kv_len != nullptr ? min(kv_len[b], Sk) : Sk;
  const int qoff = q_offset != nullptr ? q_offset[b] : q_off;
  const int p_lo = qoff + r0 / G;                         // row positions
  const int p_hi = qoff + (min(r0 + kRows, nrows) - 1) / G;
  Walk wk;
  wk.bk = block_k;
  wk.kend = causal ? min(klen, p_hi + 1) : klen;
  wk.kstart = window > 0 ? max(0, p_lo - window + 1) : 0;
  wk.blk_end = (wk.kend + block_k - 1) / block_k;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  // the first K slab in flight while q arrives; stored after q
  int blk = wk.next_live(wk.kstart / block_k);
  int stage = 0;
  int g_lo = 0, g_hi = 0;
  Staged st;
  if (blk < wk.blk_end) {
    wk.live(blk, g_lo, g_hi);
    load_k<kD>(st, kb, ks.s, blk * block_k + g_lo * kGroup,
               piece(g_hi - g_lo) * kGroup, wk.kmax(blk), 0, dv);
  }

  // q * sm_scale, transposed: sQt[d][row]; rows past Sq * G and columns
  // at or past dv are zeros
  {
    constexpr int CH = kD / 8, N = kRows * CH / kThreads;
    uint4 w[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = tid + n * kThreads, r = i % kRows, c = i / kRows;
      const int row = r0 + r;
      w[n] = row < nrows && (!kNarrow<kD> || c * 8 < dv)
                 ? *reinterpret_cast<const uint4*>(
                       q + b * qs.b + (hk * G + row % G) * qs.h +
                       (long long)(row / G) * qs.s + c * 8)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = tid + n * kThreads, r = i % kRows, c = i / kRows;
      float f[8];
      widen8(w[n], f);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sQt[(c * 8 + e) * kRows + r] = __fmul_rn(f[e], sm_scale);
    }
    if (tid < kRows) sQp[tid] = qoff + (r0 + tid) / G;
  }
  if (blk < wk.blk_end) store_k(ring, st, piece(g_hi - g_lo) * kGroup);

  // per row i of the thread's eight (rows 4 tr + i, 32 + 4 tr + i - 4):
  // acc, and per block p . v. Row lrow (row `warp` of the eight), whose
  // l the thread chains: its running m and l, the same in the four lanes
  // tc = 0 .. 3, of which tc = 0 writes the block's m_new and alpha to
  // sMn and sA for every thread.
  float m_run = kNegInf, l_run = 0.0f;
  float acc[8][C];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.0f;
  const int lrow = (warp / 4) * 32 + 4 * tr + warp % 4;

  while (blk < wk.blk_end) {
    const int km = wk.kmax(blk), k0 = blk * block_k;
    // whether every key of group g is kept for every row of the tile
    auto inner = [&](int g) {
      const int a = k0 + g * kGroup;
      return a + kGroup <= km && (!causal || a + kGroup - 1 <= p_lo) &&
             (window <= 0 || a > p_hi - window);
    };
    // ---- scores, piece by piece, into the score tile; row maxima
    float mx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) mx[i] = kNegInf;
    for (int gs = g_lo, n = piece(g_hi - g_lo); gs < g_hi;
         gs += n, n = piece(g_hi - gs)) {
      // R rows a thread: 8 / R warps a group, the warp's part of the rows
      const int R = n <= 2 ? 2 : n <= 4 ? 4 : 8;
      const int gw = warp / (8 / R), part = warp % (8 / R);
      const bool on = gw < n;
      const int rows = R == 8 ? 0 : R == 4 ? 32 * part
                                           : 32 * (part / 2) + 2 * (part % 2);
      float s[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
      for (int sl = 0; sl < kD / kSlabD; ++sl) {
        __syncthreads();            // the slab is stored; the other stage
                                    // is free
        // the next slab: the piece's next, the next piece's first, or the
        // block's first V slab
        float* nst = ring + (stage ^ 1) * kStage;
        const int nn = sl + 1 < kD / kSlabD ? n : piece(g_hi - gs - n);
        const bool nk = sl + 1 < kD / kSlabD || gs + n < g_hi;
        if (nk)
          load_k<kD>(st, kb, ks.s,
                     k0 + (sl + 1 < kD / kSlabD ? gs : gs + n) * kGroup,
                     nn * kGroup, km, (sl + 1) % (kD / kSlabD), dv);
        else
          load_v<kD>(st, vb, vs.s, k0 + g_lo * kGroup, km, dv);
        if (on) {
          const float* kst = ring + stage * kStage +
                             (gw * kGroup + tc) * kSlabD;
          const float* qt = sQt + sl * kSlabD * kRows + rows + 4 * tr;
          if (R == 8)
            score_slab<8>(qt, kst, s);
          else if (R == 4)
            score_slab<4>(qt, kst, s);
          else
            score_slab<2>(qt, kst, s);
        }
        if (nk)
          store_k(nst, st, nn * kGroup);
        else
          store_v<kD>(nst, st);
        stage ^= 1;
      }
      if (on) {
        const int g = gs + gw;
        const bool in = inner(g);
        int qp[8];
        row_positions(sQp, tr, qp);
        if (R == 8)
          keep_scores<8, 0>(sS, s, g, tr, tc, in, k0, km, qp, causal, window,
                            mx);
        else if (R == 4)
          keep_part<4>(part, sS, s, g, tr, tc, in, k0, km, qp, causal,
                       window, mx);
        else
          keep_part<2>(part, sS, s, g, tr, tc, in, k0, km, qp, causal,
                       window, mx);
      }
    }
    // the warp's row maxima: its four lanes of a row set, then sMax[warp]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 8));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 16));
    }
    if (tc == 0) {
      float* at = sMax + warp * kRows + 4 * tr;
      *reinterpret_cast<float4*>(at) = make_float4(mx[0], mx[1], mx[2], mx[3]);
      *reinterpret_cast<float4*>(at + 32) =
          make_float4(mx[4], mx[5], mx[6], mx[7]);
    }

    // ---- p . v, group by group; the block's l chained per row
    float pv[8][C], lch = 0.0f, a_own = 1.0f;   // a_own: row lrow's
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) pv[i][j] = 0.0f;
    const int nxt = wk.next_live(blk + 1);
    int n_lo = 0, n_hi = 0;
    if (nxt < wk.blk_end) wk.live(nxt, n_lo, n_hi);
    // V slabs of kVKeys keys, SPG a group
    constexpr int VK = L::kVKeys, SPG = kGroup / VK;
    for (int hg = SPG * g_lo; hg < SPG * g_hi; ++hg) {
      const int g = hg / SPG;
      __syncthreads();
      float* nst = ring + (stage ^ 1) * kStage;
      const bool nv = hg + 1 < SPG * g_hi;
      if (nv)
        load_v<kD>(st, vb, vs.s, k0 + (hg + 1) * VK, km, dv);
      else if (nxt < wk.blk_end)
        load_k<kD>(st, kb, ks.s, nxt * block_k + n_lo * kGroup,
                   piece(n_hi - n_lo) * kGroup, wk.kmax(nxt), 0, dv);
      if (hg == SPG * g_lo) {
        // row lrow's block max, m_new and alpha, for every thread; then p
        // of the block's first two groups
        float m = sMax[lrow];
#pragma unroll
        for (int w = 1; w < 8; ++w) m = fmaxf(m, sMax[w * kRows + lrow]);
        m = fmaxf(m_run, m);
        a_own = vexp::apply_exp(BACKEND, __fsub_rn(m_run, m));
        m_run = m;
        if (tc == 0) {
          sMn[lrow] = m;
          sA[lrow] = a_own;
        }
        __syncthreads();
        for (int gp = g; gp < min(g + 2, g_hi); ++gp)
          p_group<BACKEND>(sS, gp, tr, tc, warp, inner(gp), k0, km, sQp,
                           sMn, causal, window);
        __syncthreads();            // p of the first group
      } else if (SPG == 2 && hg % 2 == 1 && g + 2 < g_hi) {
        // p of the group after next, beside this one's p . v (in its
        // second slab)
        p_group<BACKEND>(sS, g + 2, tr, tc, warp, inner(g + 2), k0, km, sQp,
                         sMn, causal, window);
      }
      if (SPG == 1 && g + 2 < g_hi)
        // one slab a group: the group after next's p in every slab
        p_group<BACKEND>(sS, g + 2, tr, tc, warp, inner(g + 2), k0, km, sQp,
                         sMn, causal, window);
      pv_slab<kD>(sS + hg * VK * kRows,
                  ring + stage * kStage + C * (4 * warp + tc), tr, lrow, pv,
                  lch);
      if (nv)
        store_v<kD>(nst, st);
      else if (nxt < wk.blk_end)
        store_k(nst, st, piece(n_hi - n_lo) * kGroup);
      stage ^= 1;
    }
    // ---- the block's one online update
    l_run = __fadd_rn(__fmul_rn(l_run, a_own), lch);
    {
      float alpha[8];
      load_f32<4>(sA + 4 * tr, alpha);
      load_f32<4>(sA + 32 + 4 * tr, alpha + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j)
          acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], alpha[i]), pv[i][j]);
    }
    blk = nxt;
    g_lo = n_lo;
    g_hi = n_hi;
  }
  if (tc == 0) sMn[lrow] = l_run;   // past the last read of sMn
  __syncthreads();                  // every row's l
  float l_all[8];
  load_f32<4>(sMn + 4 * tr, l_all);
  load_f32<4>(sMn + 32 + 4 * tr, l_all + 4);

  if constexpr (kNarrow<kD>) {
    if (C * (4 * warp + tc) >= dv) return;     // the zero-filled columns
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i / 4) * 32 + 4 * tr + i % 4;
    if (row >= nrows) continue;
    __nv_bfloat16* ob = o + b * os.b + (hk * G + row % G) * os.h +
                        (long long)(row / G) * os.s + C * (4 * warp + tc);
    const float inv = 1.0f / fmaxf(l_all[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < C; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(ob + j) =
          __floats2bfloat162_rn(__fmul_rn(acc[i][j], inv),
                                __fmul_rn(acc[i][j + 1], inv));
  }
}

template <int kD, int BACKEND>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* kv_len, const void* q_offset, int q_off, int B, int H,
           int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
           Strides os, float sm_scale, int causal, int window, int block_k,
           int dv, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fa_rows_kernel<kD, BACKEND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const long long ctas = (long long)B * Hkv *
                         (((long long)Sq * (H / Hkv) + kRows - 1) / kRows);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fa_rows_kernel<kD, BACKEND><<<(unsigned)ctas, kThreads,
                                smem_bytes<kD>(block_k), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_offset), q_off, H, Hkv, Sq, Sk, qs, ks, vs, os,
      sm_scale, causal, window, block_k, dv);
  return (int)cudaGetLastError();
}

}  // namespace fa_rows

size_t smem_bytes(int D, int block_k) {
  switch (D) {
    case 32:
      return Smem<32>::bytes(score_keys<32>(block_k));
    case 64:
      return Smem<64>::bytes(score_keys<64>(block_k));
    case 120:
    case 128:
      return fa_rows::smem_bytes<128>(block_k);
    case 256:
      return fa_rows::smem_bytes<256>(block_k);
    default:
      return 0;
  }
}

template <int D, int BACKEND>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* kv_len, const void* q_offset, int q_off, int B,
           int H, int Hkv, int Sq, int Sk, Strides qs, Strides ks,
           Strides vs, Strides os, float sm_scale, int causal, int window,
           int block_k, cudaStream_t stream) {
  if constexpr (D >= 120) {
    // head dim 120 runs the D 128 kernel on zero-filled columns
    return fa_rows::launch<D == 120 ? 128 : D, BACKEND>(
        q, k, v, o, kv_len, q_offset, q_off, B, H, Hkv, Sq, Sk, qs, ks, vs,
        os, sm_scale, causal, window, block_k, D, stream);
  } else {
    // the shared-memory limit, raised to the card's once per instantiation
    // and device
    constexpr int kMaxDevices = 64;
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!raised[dev]) {
      int optin = 0;
      err = cudaDeviceGetAttribute(&optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev);
      if (err != cudaSuccess) return (int)err;
      err = cudaFuncSetAttribute(fa_fwd_kernel<D, BACKEND>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
      if (err != cudaSuccess) return (int)err;
      raised[dev] = true;
    }
    const size_t smem = Smem<D>::bytes(score_keys<D>(block_k));
    constexpr int kBQ = Tile<D>::kBQ;
    dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
    fa_fwd_kernel<D, BACKEND><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_len),
        static_cast<const int*>(q_offset), q_off, H, Hkv, Sq, Sk, qs, ks, vs,
        os, sm_scale, causal, window, block_k);
    return (int)cudaGetLastError();
  }
}

template <int D>
int launch_exp(int backend, const void* q, const void* k, const void* v,
               void* o, const void* kv_len, const void* q_offset, int q_off,
               int B, int H, int Hkv, int Sq, int Sk, Strides qs, Strides ks,
               Strides vs, Strides os, float sm_scale, int causal,
               int window, int block_k, cudaStream_t s) {
  switch (backend) {
    case vexp::kExact:
      return launch<D, vexp::kExact>(q, k, v, o, kv_len, q_offset, q_off, B,
                                     H, Hkv, Sq, Sk, qs, ks, vs, os,
                                     sm_scale, causal, window, block_k, s);
    case vexp::kVexp:
      return launch<D, vexp::kVexp>(q, k, v, o, kv_len, q_offset, q_off, B,
                                    H, Hkv, Sq, Sk, qs, ks, vs, os, sm_scale,
                                    causal, window, block_k, s);
    case vexp::kVexpHw:
      return launch<D, vexp::kVexpHw>(q, k, v, o, kv_len, q_offset, q_off,
                                      B, H, Hkv, Sq, Sk, qs, ks, vs, os,
                                      sm_scale, causal, window, block_k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.s % 8 == 0;
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Hkv,Sk,D), o (B,H,Sq,D): bf16, the last dim packed;
// q, k and v 16-byte aligned with every stride a multiple of 8 elements
// (whole 16-byte rows), o 4-byte aligned with even strides
// (bf16 pairs are stored). kv_len: (B,) int32 or null (every key real).
// q_offset: (B,) int32, or null and then q_off for every row. window <= 0
// means no window. Returns cudaGetLastError() after the launch.
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      const void* kv_len, const void* q_offset, int B,
                      int H, int Hkv, int Sq, int Sk, int D,
                      long long qsb, long long qsh, long long qss,
                      long long ksb, long long ksh, long long kss,
                      long long vsb, long long vsh, long long vss,
                      long long osb, long long osh, long long oss,
                      float sm_scale, int causal, int window, int block_k,
                      int q_off, int backend, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  if (block_k < 1 || Hkv < 1 || H % Hkv != 0 || !aligned16(q, qs) ||
      !aligned16(k, ks) || !aligned16(v, vs) ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0 ||
      (os.b | os.h | os.s) % 2 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_exp<32>(backend, q, k, v, o, kv_len, q_offset, q_off, B,
                            H, Hkv, Sq, Sk, qs, ks, vs, os, sm_scale, causal,
                            window, block_k, s);
    case 64:
      return launch_exp<64>(backend, q, k, v, o, kv_len, q_offset, q_off, B,
                            H, Hkv, Sq, Sk, qs, ks, vs, os, sm_scale, causal,
                            window, block_k, s);
    case 120:
      return launch_exp<120>(backend, q, k, v, o, kv_len, q_offset, q_off,
                             B, H, Hkv, Sq, Sk, qs, ks, vs, os, sm_scale,
                             causal, window, block_k, s);
    case 128:
      return launch_exp<128>(backend, q, k, v, o, kv_len, q_offset, q_off,
                             B, H, Hkv, Sq, Sk, qs, ks, vs, os, sm_scale,
                             causal, window, block_k, s);
    case 256:
      return launch_exp<256>(backend, q, k, v, o, kv_len, q_offset, q_off,
                             B, H, Hkv, Sq, Sk, qs, ks, vs, os, sm_scale,
                             causal, window, block_k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory bytes a launch needs (the wrapper checks it
// against the card's per-block limit before launching): the score tile
// holds a block of block_k keys, rounded up to whole sub-tiles (at D =
// 256, whole 32-key groups).
extern "C" long long fa_smem_bytes(int D, int block_k) {
  return (long long)smem_bytes(D, block_k);
}
