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
// Design: the sequence-split sweep of decode_split.cuh with the page as
// the update block. A tile is one page (or a 64-key part of a larger
// page), and the K and V passes run one CTA per (tile, KV head, batch
// row), each taking its pool page from the row's table and copying the
// page's kept rows with cp.async: at batch 8, 12 heads and 16 pages per
// row that is up to 1,536 CTAs per pass on 132 SMs (192 at batch 1).
// Pages at or past cache_len (table entries that point at the scratch
// page 0) and below the window are never read. The p @ v pass takes p
// against the running max after the tile's page, formed exactly from
// the page maxes; the row's last p @ v CTA to finish (an atomic ticket)
// chains the pages' (l, p @ v) with one alpha per page in page order, as
// the Pallas grid steps. Two kernel launches per call; the scores, tile
// statistics and tickets live in one scratch buffer from the caller.
//
// Also replaces decode_attention_kernel_paged_partial and
// decode_attention_kernel_paged_packed (_paged_kernel with partial=True,
// and packed=True): the same sweep over one shard of a sequence-sharded
// pool, differing only in the chain's epilogue. The pool is the
// shard's own (local page ids, its page 0 the scratch page) and
// block_tab its (B, nS) slice of the table columns, whose logical page 0
// sits at global position seq_offset; cache_len stays global, so local
// token t is kept when cache_len - window <= t + seq_offset < cache_len.
// Instead of the normalized output the sweep writes its raw f32
// statistics: m and l (B,Hkv,G,1) and acc (B,Hkv,G,d) (partial), or one
// (B,Hkv,G,d+2) tile laid out [acc | m | l] (packed). A row with no key
// on this shard chains no page and writes the merge identity
// (KERNEL_NEG_INF = -1e30, 0, 0), never -inf. The statistics written are
// (d+2)*4 bytes per query row.

#include "decode_split.cuh"

namespace {

template <int MODE>
int run(const void* q, const void* kp, const void* vp, void* o, void* om,
        void* ol, void* scratch, long long scratch_len, const void* tab,
        const void* cache_len, int B, int Hkv, int G, int D, int page,
        int nS, long long psn, long long psh, long long pst, float sm_scale,
        int window, int seq_offset, int backend, void* stream) {
  if (page < 1 || nS < 0) return (int)cudaErrorInvalidValue;
  split::Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(kp);
  a.v = static_cast<const __nv_bfloat16*>(vp);
  a.o = o;
  a.om = static_cast<float*>(om);
  a.ol = static_cast<float*>(ol);
  a.cache_len = static_cast<const int*>(cache_len);
  a.tab = static_cast<const int*>(tab);
  a.B = B;
  a.Hkv = Hkv;
  a.G = G;
  a.S = nS * page;
  a.nS = nS;
  a.block = page;
  a.sb = psn;
  a.sh = psh;
  a.ss = pst;
  a.sm_scale = sm_scale;
  a.window = window;
  a.seq_offset = seq_offset;
  a.backend = backend;
  return split::run<MODE, true>(a, D, static_cast<float*>(scratch),
                                scratch_len,
                                static_cast<cudaStream_t>(stream));
}

}  // namespace

// All three entries take the same arguments. q: (B,Hkv,G,D) packed bf16;
// K/V pools bf16, page p / head h / token t of a pool at
// base + p*psn + h*psh + t*pst (+ d, packed), rows 16-byte aligned;
// scratch: scratch_len f32 elements, at least
// B*Hkv*(G*nT*(64 + 3 + D) + 1), at D = 128 and 256
// B*Hkv*(nT*64*chain_rows(D, G) + G*(nT + nB*(D + 2))) (D = 120: as
// D = 128), with nT = max(nS * ceil(page
// / 64), 1) tiles and nB = max(nS, 1) pages per row; block_tab: (B,nS)
// int32 packed, pool page ids, logical
// page 0 at global position seq_offset; cache_len: (B,) int32 global
// lengths. window <= 0 means no window. G <= 8 (16 at D = 120, 128 and 256,
// normalized mode only). Each launches the sweep's
// kernels (two; three at D = 120, 128, 256) and returns cudaGetLastError() after the
// last launch (or the first failed one).
//
// paged_decode_fwd: o (B,Hkv,G,D) bf16, the normalized output (om, ol
// unused).
extern "C" int paged_decode_fwd(const void* q, const void* kp,
                                const void* vp, void* o, void* om, void* ol,
                                void* scratch, long long scratch_len,
                                const void* tab, const void* cache_len,
                                int B, int Hkv, int G, int D, int page,
                                int nS, long long psn, long long psh,
                                long long pst, float sm_scale, int window,
                                int seq_offset, int backend, void* stream) {
  return run<split::kNormalized>(q, kp, vp, o, om, ol, scratch, scratch_len,
                                 tab, cache_len, B, Hkv, G, D, page, nS, psn,
                                 psh, pst, sm_scale, window, seq_offset,
                                 backend, stream);
}

// paged_decode_partial_fwd: o = acc (B,Hkv,G,D), om = m and ol = l
// (B,Hkv,G,1), all f32.
extern "C" int paged_decode_partial_fwd(
    const void* q, const void* kp, const void* vp, void* o, void* om,
    void* ol, void* scratch, long long scratch_len, const void* tab,
    const void* cache_len, int B, int Hkv, int G, int D, int page, int nS,
    long long psn, long long psh, long long pst, float sm_scale, int window,
    int seq_offset, int backend, void* stream) {
  return run<split::kPartial>(q, kp, vp, o, om, ol, scratch, scratch_len,
                              tab, cache_len, B, Hkv, G, D, page, nS, psn,
                              psh, pst, sm_scale, window, seq_offset, backend,
                              stream);
}

// paged_decode_packed_fwd: o = the (B,Hkv,G,D+2) f32 tile [acc | m | l]
// (om, ol unused).
extern "C" int paged_decode_packed_fwd(
    const void* q, const void* kp, const void* vp, void* o, void* om,
    void* ol, void* scratch, long long scratch_len, const void* tab,
    const void* cache_len, int B, int Hkv, int G, int D, int page, int nS,
    long long psn, long long psh, long long pst, float sm_scale, int window,
    int seq_offset, int backend, void* stream) {
  return run<split::kPacked>(q, kp, vp, o, om, ol, scratch, scratch_len, tab,
                             cache_len, B, Hkv, G, D, page, nS, psn, psh, pst,
                             sm_scale, window, seq_offset, backend, stream);
}
