"""On the card: in which orientation does torch's f32 matrix product sum
each dot product in order? Compares the products the plain decode sweep
could be written with against an in-order f32 FMA chain over the summed
axis (emulated in float64, rounded to f32 after every step), at the
decode shapes of the port's families. Prints one JSON line a shape:
the number of outputs of each formulation that differ from the chain
(and, for p @ v, from chains over 64-key tiles summed in tile order).

    python3 tools/matmul_order.py

At recurrentgemma's decode shape (16 query rows on one KV head, d 256)
the key-major products ``(keys, d) @ (d, G)`` and ``(d, keys) @ (keys,
G)`` match the chain at 64 and 512 keys, while ``einsum`` sums p @ v in
another order; this is why ``kernels/decode_attention.py``'s plain sweep
is written key-major at D 256; phi3-medium's shapes (4 query rows a KV
head, 10 KV heads, d 128) are read the same way. Then lines read a
block's l (the row sums of p) taken as a product of p with a column of
ones, or with D columns, in the decode sweep's key-major orientation
and in FA's einsum, against one f32 chain over the keys in order; the
last line reads FA's two einsums (scores over d, p . v over a block's
keys) at phi3's wave against in-order chains.
"""

import json

import torch


def chain(a, b):
    """a (..., M, K) @ b (..., K, N), each output an f32 FMA chain over K
    in order."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-1],), dtype=torch.float64,
                      device=a.device)
    for k in range(a.shape[-1]):
        acc = (acc + a[..., k:k + 1].double()
               * b[..., k:k + 1, :].double()).float().double()
    return acc.float()


def tiles(a, b, t=64):
    out = None
    for k0 in range(0, a.shape[-1], t):
        c = chain(a[..., k0:k0 + t], b[..., k0:k0 + t, :])
        out = c if out is None else out + c
    return out


def key_sum(p):
    """p (..., K) summed over K as one f32 chain in order."""
    acc = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    for k in range(p.shape[-1]):
        acc = acc + p[..., k]
    return acc


def differ(x, y):
    return int((x != y).sum())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script reads the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(3)

    def bf16_randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16).float()

    for G, D, H in ((16, 256, 1), (1, 64, 1), (4, 128, 10)):
        for K in (512, 64):
            q, k, v = bf16_randn(8, H, G, D), bf16_randn(8, H, K, D), \
                bf16_randn(8, H, K, D)
            sc = chain(q, k.transpose(-1, -2))
            s = torch.einsum("bkgd,bktd->bkgt", q, k)
            p = torch.softmax(s / D ** 0.5, -1).to(torch.bfloat16).float()
            pc, pt = chain(p, v), tiles(p, v)
            pv_e = torch.einsum("bkgt,bktd->bkgd", p, v)
            pv_k = (v.transpose(-1, -2) @ p.transpose(-1, -2)).transpose(
                -1, -2)
            print(json.dumps({
                "G": G, "d": D, "keys": K, "outputs": s.numel(),
                "scores_einsum_vs_chain": differ(s, sc),
                "scores_keymajor_vs_chain": differ(
                    (k @ q.transpose(-1, -2)).transpose(-1, -2), sc),
                "pv_outputs": pv_e.numel(),
                "pv_einsum_vs_chain": differ(pv_e, pc),
                "pv_einsum_vs_tiles64": differ(pv_e, pt),
                "pv_keymajor_vs_chain": differ(pv_k, pc),
                "pv_keymajor_vs_tiles64": differ(pv_k, pt),
                "device": torch.cuda.get_device_name(0)}), flush=True)
    # a block's l, the row sums of p, as the plain versions take it at
    # D 256: a product of p with ones in the orientation of their p @ v,
    # with one column of ones or D columns (of which one is kept)
    for G, D, H in ((16, 256, 1), (4, 128, 10)):
        for K in (512, 64):
            s = bf16_randn(8, H, G, K)
            p = torch.softmax(s, -1)
            lc = key_sum(p)
            pt = p.contiguous().transpose(-1, -2)
            vt = bf16_randn(8, H, K, D).transpose(-1, -2)
            print(json.dumps({
                "l": "decode", "G": G, "d": D, "keys": K,
                "outputs": lc.numel(),
                "l_ones1_keymajor_vs_chain": differ(
                    (torch.ones_like(vt[..., :1, :]) @ pt)[..., 0, :], lc),
                "l_onesD_keymajor_vs_chain": differ(
                    (torch.ones_like(vt) @ pt)[..., 0, :], lc),
                "device": torch.cuda.get_device_name(0)}), flush=True)
    for G, D, S, H in ((16, 256, 2048, 1), (16, 256, 256, 1),
                       (16, 256, 5, 1), (4, 128, 1024, 10),
                       (4, 128, 256, 10)):
        K = 512
        p = torch.softmax(bf16_randn(8, H, G, S, K), -1)
        lc = key_sum(p)
        v = bf16_randn(8, K, H, D)
        print(json.dumps({
            "l": "flash", "G": G, "d": D, "queries": S, "keys": K,
            "outputs": lc.numel(),
            "l_ones1_einsum_vs_chain": differ(torch.einsum(
                "bkgst,btkd->bkgsd", p, torch.ones_like(v[..., :1]))[..., 0],
                lc),
            "l_onesD_einsum_vs_chain": differ(torch.einsum(
                "bkgst,btkd->bkgsd", p, torch.ones_like(v))[..., 0], lc),
            "device": torch.cuda.get_device_name(0)}), flush=True)
    # FA's einsums at phi3-medium's wave (4 query heads a KV head, d 128,
    # a 512-key block; 2 batch rows, 2 KV heads, 256 queries): each score
    # against a chain over d, each p . v against a chain over the keys
    G, D, S, H, K = 4, 128, 256, 2, 512
    qg = bf16_randn(2, S, H, G, D)
    k, v = bf16_randn(2, K, H, D), bf16_randn(2, K, H, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k)
    sc = chain(qg.permute(0, 2, 3, 1, 4), k.permute(0, 2, 3, 1)[:, :, None])
    p = torch.softmax(s, -1).to(torch.bfloat16).float()
    pv = torch.einsum("bkgst,btkd->bkgsd", p, v)
    pc = chain(p, v.permute(0, 2, 1, 3)[:, :, None])
    print(json.dumps({
        "fa": "einsum", "G": G, "d": D, "queries": S, "keys": K,
        "outputs": s.numel(), "scores_einsum_vs_chain": differ(s, sc),
        "pv_outputs": pv.numel(), "pv_einsum_vs_chain": differ(pv, pc),
        "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
