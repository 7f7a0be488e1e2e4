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
// Design: the sequence-split sweep of decode_split.cuh. Each update block
// of block_s keys is cut into 64-key tiles, and the K and V passes run one
// CTA per (tile, KV head, batch row): at batch 8, 12 heads and 1,024 keys
// that is up to 1,536 CTAs per pass on 132 SMs (192 at batch 1), each
// copying its tile's 8 KB of K or V with cp.async. Tiles that hold no kept
// key (past the row's length, below its window) load nothing. The scores
// pass writes f32 scores (1/32 of the K bytes at d = 64) and each tile's
// max; the p @ v pass takes p against m_j, the running max after the
// tile's update block, formed exactly from the tile maxes, so every exp
// argument is the plain sweep's; the row's last p @ v CTA to finish
// (an atomic ticket) chains the blocks' (l, p @ v) with one alpha per
// block in block order. Two kernel launches per call; the scores, tile
// statistics and tickets live in one scratch buffer from the caller.
//
// Also replaces decode_attention_kernel_partial and
// decode_attention_kernel_packed (_decode_kernel with partial=True, and
// packed=True): the same sweep over one shard of a sequence-sharded
// cache, differing only in the chain's epilogue. The cache pointers
// address the shard's local slice of S rows, whose first row sits at
// global position seq_offset; cache_len stays global, so a key at local
// row r is kept when cache_len - window <= r + seq_offset < cache_len.
// Blocks count from the slice's local row 0, as the Pallas grid does.
// Instead of the normalized output the sweep writes its raw f32
// statistics: m and l (B,Hkv,G,1) and acc (B,Hkv,G,d) (partial), or one
// (B,Hkv,G,d+2) tile laid out [acc | m | l] (packed; no lane padding,
// unlike the reference's d_pad + 2). A row with no key on this shard
// chains no block and writes the merge identity (KERNEL_NEG_INF = -1e30,
// 0, 0): every output element is written, and never -inf (vexp of
// -inf - -inf is NaN). The statistics written are (d+2)*4 bytes per
// query row.

#include "decode_split.cuh"

namespace {

template <int MODE>
int run(const void* q, const void* kc, const void* vc, void* o, void* om,
        void* ol, void* scratch, long long scratch_len,
        const void* cache_len, int B, int Hkv, int G, int S, int D,
        long long csb, long long csh, long long css, float sm_scale,
        int window, int block_s, int seq_offset, int backend, void* stream) {
  split::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(kc);
  a.v = static_cast<const __nv_bfloat16*>(vc);
  a.o = o;
  a.om = static_cast<float*>(om);
  a.ol = static_cast<float*>(ol);
  a.cache_len = static_cast<const int*>(cache_len);
  a.B = B;
  a.Hkv = Hkv;
  a.G = G;
  a.S = S;
  a.block = block_s;
  a.sb = csb;
  a.sh = csh;
  a.ss = css;
  a.sm_scale = sm_scale;
  a.window = window;
  a.seq_offset = seq_offset;
  a.backend = backend;
  return split::run<MODE, false>(a, D, static_cast<float*>(scratch),
                                 scratch_len,
                                 static_cast<cudaStream_t>(stream));
}

}  // namespace

// All three entries take the same arguments. q: (B,Hkv,G,D) packed bf16;
// k/v cache bf16 addressed as base + b*csb + h*csh + s*css (+ d, packed),
// rows 16-byte aligned, S rows from global position seq_offset on;
// scratch: scratch_len f32 elements, at least
// B*Hkv*(G*nT*(64 + 3 + D) + 1), at D = 128 and 256
// B*Hkv*(nT*64*chain_rows(D, G) + G*(nT + nB*(D + 2))) (D = 120: as
// D = 128), with nB = max(ceil(S / bs), 1)
// update blocks and nT = nB * ceil(bs / 64) tiles per row,
// bs = max(min(block_s, S), 1); cache_len: (B,) int32
// global lengths. window <= 0 means no window. G <= 8 (16 at D = 120, 128 and 256,
// normalized mode only). Each launches the
// sweep's kernels (two; three at D = 120, 128, 256) and returns cudaGetLastError()
// after the last launch (or the first failed one).
//
// decode_fwd: o (B,Hkv,G,D) bf16, the normalized output (om, ol unused).
extern "C" int decode_fwd(const void* q, const void* kc, const void* vc,
                          void* o, void* om, void* ol, void* scratch,
                          long long scratch_len, const void* cache_len,
                          int B, int Hkv, int G, int S, int D, long long csb,
                          long long csh, long long css, float sm_scale,
                          int window, int block_s, int seq_offset,
                          int backend, void* stream) {
  return run<split::kNormalized>(q, kc, vc, o, om, ol, scratch, scratch_len,
                                 cache_len, B, Hkv, G, S, D, csb, csh, css,
                                 sm_scale, window, block_s, seq_offset,
                                 backend, stream);
}

// decode_partial_fwd: o = acc (B,Hkv,G,D), om = m and ol = l (B,Hkv,G,1),
// all f32.
extern "C" int decode_partial_fwd(const void* q, const void* kc,
                                  const void* vc, void* o, void* om, void* ol,
                                  void* scratch, long long scratch_len,
                                  const void* cache_len, int B, int Hkv,
                                  int G, int S, int D, long long csb,
                                  long long csh, long long css,
                                  float sm_scale, int window, int block_s,
                                  int seq_offset, int backend, void* stream) {
  return run<split::kPartial>(q, kc, vc, o, om, ol, scratch, scratch_len,
                              cache_len, B, Hkv, G, S, D, csb, csh, css,
                              sm_scale, window, block_s, seq_offset, backend,
                              stream);
}

// decode_packed_fwd: o = the (B,Hkv,G,D+2) f32 tile [acc | m | l] (om, ol
// unused).
extern "C" int decode_packed_fwd(const void* q, const void* kc,
                                 const void* vc, void* o, void* om, void* ol,
                                 void* scratch, long long scratch_len,
                                 const void* cache_len, int B, int Hkv, int G,
                                 int S, int D, long long csb, long long csh,
                                 long long css, float sm_scale, int window,
                                 int block_s, int seq_offset, int backend,
                                 void* stream) {
  return run<split::kPacked>(q, kc, vc, o, om, ol, scratch, scratch_len,
                             cache_len, B, Hkv, G, S, D, csb, csh, css,
                             sm_scale, window, block_s, seq_offset, backend,
                             stream);
}
