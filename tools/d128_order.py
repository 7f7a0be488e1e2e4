"""On the card: which summation order the head-dim-128 attention kernels
take, read against the unchanged ``ATT_LIMITS`` at phi3-medium's shapes.

phi3-medium-14b has 40 query heads on 10 KV heads (G 4) of head dim 128.
Its FlashAttention (B3) runs ``fa_rows``, which chains each block's l over
the block's keys in order; its plain version can sum l as
``torch.sum`` does (``core.attention.attention_flash``) or as one chain
(``_attention_flash_l_chain``, ``L_CHAIN_DIMS``). Its flash-decode (B2,
B7) can sum per-tile partials (``split_scores`` / ``split_pv``, the D 32
/ 64 design) or chain each update block in key order (``block_chain``,
the D 256 design), against a plain sweep written with einsum / sum or
key-major (``KEY_MAJOR_DIMS``). This builds both decode designs (copies
of the sources with ``kChainMinD`` at 128 and at 256), and holds every
kernel to both plain versions under every exp backend at:

* FA: the wave (B 8, S 1024, ragged kv_len, block_k 512) and a chunk
  (256 queries at (B,) offsets over 2,048 keys);
* B2: B 8, a 2,048-token cache, ragged cache_len, "bshd" and "bhsd";
* B7: the same through a page-64 table in random order.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/d128_order.py [--d 120]

One JSON line a (kernel, design, plain version, exp backend): max |err|,
the share of outputs changed and whether ``ATT_LIMITS`` hold, then the
ptxas report (registers, spills) of the D 128 kernels.

``--d 120`` reads h2o-danube3-4b's head dim (32 query heads on 8 KV
heads, G 4, d 120) instead: first which order cuBLAS's f32 products take
at d 120 (each plain product against an in-order f32 chain, the count of
outputs that differ), with the operands as they are and zero-padded to
128 columns, as the reference's ops pad them, at G 4 and at the edge
cases' G 1 (one query row, and with a second, zero row); then, where
the kernels take head dim 120, FA, B2 and B7 against their plain
versions under every exp backend.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.limits import ATT_LIMITS  # noqa: E402
from repro_torch.runtime import ExecPolicy  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
DESIGNS = {"chain": 128, "tiles": 256}        # kChainMinD of each copy
DECODE_SOURCES = {"decode_attention.cu": da.LIB,
                  "decode_attention_paged.cu": da.PAGED_LIB}
B, S, H, HKV, D, PAGE = 8, 2048, 40, 10, 128, 64


def reading(out, ref, real=None):
    o, r = out.float(), ref.float()
    if real is not None:
        sel = real.expand_as(o)
        o, r = o[sel], r[sel]
    return float((o - r).abs().max()), float((o != r).double().mean())


def line(kernel, design, plain, exp, err, share):
    lim_err, lim_share = ATT_LIMITS[kernel][exp]
    print(json.dumps({
        "kernel": kernel, "design": design, "plain": plain, "exp": exp,
        "max_abs_err": err, "mismatch_share": share,
        "inside_limits": err <= lim_err and share <= lim_share}),
        flush=True)


def fa_order():
    g = torch.Generator(device="cuda").manual_seed(21)
    sq = 1024
    q = torch.randn(B, sq, H, D, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, HKV, D, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    kv_len = torch.randint(32, sq + 1, (B,), generator=g, device="cuda",
                           dtype=torch.int32)
    kv_len[0] = sq
    qc = torch.randn(B, 256, H, D, generator=g, device="cuda").bfloat16()
    offs = torch.tensor([0, 256, 1792, 0, 1000, 512, 1500, 1536],
                        dtype=torch.int32, device="cuda")
    clens = torch.tensor([256, 256, 256, 0, 200, 37, 256, 100],
                         dtype=torch.int32, device="cuda")
    cases = {"wave": (q, k[:, :sq], v[:, :sq], kv_len, 0),
             "chunk": (qc, k, v, offs + clens, offs)}
    for name, (qq, kk, vv, kl, off) in cases.items():
        pos = torch.arange(qq.shape[1], device="cuda")[None, :] + \
            torch.as_tensor(off, device="cuda").reshape(-1, 1)
        real = (pos < kl[:, None])[:, :, None, None]
        kw = dict(causal=True, kv_len=kl, q_offset=off, block_k=512)
        for exp in EXPS:
            out = fa.flash_attention(
                qq, kk, vv, causal=True, kv_len=kl, q_offset=off,
                policy=ExecPolicy(exp_backend=exp, block_k=512))
            for plain, dims in (("l_chain", (128, 256)), ("sum", (256,))):
                fa.L_CHAIN_DIMS = dims
                ref = fa.flash_attention_plain(qq, kk, vv, exp_backend=exp,
                                               **kw)
                line("flash_attention", f"fa_rows {name}", plain, exp,
                     *reading(out, ref, real))
    fa.L_CHAIN_DIMS = (128, 256)


def decode_inputs():
    g = torch.Generator(device="cuda").manual_seed(22)
    q = torch.randn(B, 1, H, D, generator=g, device="cuda").bfloat16()
    cl = torch.randint(33, S + 1, (B,), generator=g, device="cuda",
                       dtype=torch.int32)
    cl[0] = S
    kc, vc = (torch.randn(B, S, HKV, D, generator=g, device="cuda")
              .bfloat16() for _ in range(2))
    ns = S // PAGE
    kp, vp = (torch.randn(1 + B * ns, PAGE, HKV, D, generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    tab = ((torch.randperm(B * ns, generator=g, device="cuda") + 1)
           .reshape(B, ns).to(torch.int32))
    return q, cl, kc, vc, kp, vp, tab


def decode_order(design: str):
    """One decode design (its build loaded in this process) against both
    plain sweeps."""
    vdir = ROOT / "build" / "d128_order" / design
    for cu, lib in DECODE_SOURCES.items():
        lib._lib = ctypes.CDLL(os.fspath(vdir / Path(cu).with_suffix(".so")))
        lib._fns = {}
    chained = DESIGNS[design] <= D
    q, cl, kc, vc, kp, vp, tab = decode_inputs()
    kernel_dims = (128, 256) if chained else (256,)

    def plain_dims(dims):
        da.KEY_MAJOR_DIMS = dims
        da.MAX_GROUP = {d: 16 if d in dims else 8 for d in da.HEAD_DIMS}

    for exp in EXPS:
        pol = ExecPolicy(exp_backend=exp, block_page=PAGE)
        plain_dims(kernel_dims)
        outs = {}
        for lay in ("bshd", "bhsd"):
            kl, vl = ((kc, vc) if lay == "bshd" else
                      (kc.transpose(1, 2).contiguous(),
                       vc.transpose(1, 2).contiguous()))
            outs["decode_attention", lay] = (
                da.decode_attention(q, kl, vl, cl, layout=lay, policy=pol),
                lambda kl=kl, vl=vl, lay=lay: da.decode_attention_plain(
                    q, kl, vl, cl, layout=lay, block_s=pol.block_s,
                    exp_backend=exp))
        outs["decode_attention_paged", "bshd"] = (
            da.decode_attention_paged(q, kp, vp, tab, cl, layout="bshd",
                                      policy=pol),
            lambda: da.decode_attention_paged_plain(
                q, kp, vp, tab, cl, layout="bshd", exp_backend=exp))
        for plain, dims in (("key_major", (128, 256)), ("einsum", (256,))):
            plain_dims(dims)
            for (kernel, lay), (out, ref) in outs.items():
                line(kernel, f"{design} {lay}", plain, exp,
                     *reading(out, ref()))


def build_designs():
    src = (build.CSRC / "decode_split.cuh").read_text()
    old = "constexpr int kChainMinD = 128;"
    if src.count(old) != 1:
        sys.exit(f"[d128_order] {old!r} is not once in decode_split.cuh")
    procs = {}
    for design, dmin in DESIGNS.items():
        vdir = ROOT / "build" / "d128_order" / design
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "decode_split.cuh").write_text(
            src.replace(old, f"constexpr int kChainMinD = {dmin};"))
        for f in ("vexp.cuh",) + tuple(DECODE_SOURCES):
            shutil.copy(build.CSRC / f, vdir / f)
        for cu in DECODE_SOURCES:
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(vdir),
                   "-o", str(vdir / Path(cu).with_suffix(".so")),
                   str(vdir / cu)]
            procs[design, cu] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    for (design, cu), proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"[d128_order] nvcc failed on {design} {cu}:\n{out}")
        print(json.dumps({"ptxas": f"{design} {cu}", "d128": [
            ln for ln in out.splitlines()
            if "128" in ln and ("registers" in ln or "spill" in ln
                                or "Compiling" in ln)][:24]}), flush=True)


def pad_to(x, d):
    return torch.nn.functional.pad(x, (0, d - x.shape[-1]))


def order_d120():
    """Which order cuBLAS sums the plain versions' products in at d 120,
    unpadded and padded to 128: the decode sweep's key-major products
    and l (8 KV heads at G 4, one KV head at G 1 as one row and as two;
    a 512- and a 64-key block) and FA's einsums (scores, p . v and l at
    a 512-key block, 256 queries)."""
    sys.path.insert(0, str(ROOT / "tools"))
    from matmul_order import chain, differ, key_sum
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(23)

    def bf16_randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16).float()

    dev = torch.cuda.get_device_name(0)
    # danube's G 4 on 8 KV heads, and the edge cases' G 1 on one KV head,
    # whose single query row cuBLAS takes through its matrix-vector path;
    # with a second, zero row (rows 2) through the matrix product's
    for (G, H, R), K in ((c, k_) for c in ((4, 8, 4), (1, 1, 1), (1, 1, 2))
                         for k_ in (512, 64)):
        q, k, v = (bf16_randn(8, H, G, 120), bf16_randn(8, H, K, 120),
                   bf16_randn(8, H, K, 120))
        sc = chain(q, k.transpose(-1, -2))
        p = torch.softmax(sc / 120 ** 0.5, -1)
        pr = p.to(torch.bfloat16).float()
        pc, lc = chain(pr, v), key_sum(p)

        def rows(t):
            return torch.nn.functional.pad(t, (0, 0, 0, R - G))
        for pad in (120, 128):
            qq, kk, vv = (pad_to(t, pad) for t in (q, k, v))
            vt = vv.transpose(-1, -2)
            print(json.dumps({
                "order": "decode key-major", "d": 120, "padded_to": pad,
                "G": G, "rows": R, "kv_heads": H, "keys": K,
                "outputs": sc.numel(),
                "scores_vs_chain": differ((kk @ rows(qq).transpose(-1, -2))
                                          .transpose(-1, -2)[..., :G, :],
                                          sc),
                "pv_vs_chain": differ(
                    (vt @ rows(pr).transpose(-1, -2)).transpose(-1, -2)
                    [..., :G, :120], pc),
                "l_onesD_vs_chain": differ(
                    (torch.ones_like(vt) @ rows(p).transpose(-1, -2))
                    [..., 0, :G], lc),
                "device": dev}), flush=True)
    S, K = 256, 512
    qg = bf16_randn(2, S, 2, 4, 120)
    k, v = bf16_randn(2, K, 2, 120), bf16_randn(2, K, 2, 120)
    sc = chain(qg.permute(0, 2, 3, 1, 4), k.permute(0, 2, 3, 1)[:, :, None])
    p = torch.softmax(sc, -1)
    pr = p.to(torch.bfloat16).float()
    pc = chain(pr, v.permute(0, 2, 1, 3)[:, :, None])
    lc = key_sum(p)
    for pad in (120, 128):
        qq, kk, vv = (pad_to(t, pad) for t in (qg, k, v))
        print(json.dumps({
            "order": "fa einsum", "d": 120, "padded_to": pad, "G": 4,
            "queries": S, "keys": K, "outputs": sc.numel(),
            "scores_vs_chain": differ(
                torch.einsum("bskgd,btkd->bkgst", qq, kk), sc),
            "pv_vs_chain": differ(
                torch.einsum("bkgst,btkd->bkgsd", pr, vv)[..., :120], pc),
            "l_onesD_vs_chain": differ(torch.einsum(
                "bkgst,btkd->bkgsd", p, torch.ones_like(vv))[..., 0], lc),
            "device": dev}), flush=True)


def kernels_d120():
    """FA, B2 and B7 at d 120 against their plain versions under every
    exp backend: the kernels run their D 128 instantiation with columns
    120-127 zero-filled in shared memory, the plain versions their
    unpadded key-major / l-chain products."""
    if 120 not in fa.HEAD_DIMS or 120 not in da.HEAD_DIMS:
        print(json.dumps({"kernels_d120": "the kernels take no head dim "
                          "120 yet"}), flush=True)
        return
    paths = build.build_all(["flash_attention.cu", *DECODE_SOURCES])
    for src, path in paths.items():
        log = path.with_suffix(".log").read_text()
        print(json.dumps({"ptxas": src, "lines": [
            ln for ln in log.splitlines()
            if re.search(r"spill|registers", ln)][:40]}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(24)
    h, hkv, d, s = 32, 8, 120, 4096

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    sq = 1024
    q, k, v = randn(4, sq, h, d), randn(4, sq, hkv, d), randn(4, sq, hkv, d)
    kv_len = torch.tensor([sq, 700, 33, 1000], dtype=torch.int32,
                          device="cuda")
    real = (torch.arange(sq, device="cuda")[None] < kv_len[:, None])[
        :, :, None, None]
    qd = randn(8, 1, h, d)
    cl = torch.randint(1, s + 1, (8,), generator=gen, device="cuda",
                       dtype=torch.int32)
    cl[0] = s
    kc, vc = randn(8, s, hkv, d), randn(8, s, hkv, d)
    ns = s // PAGE
    kp, vp = randn(1 + 8 * ns, PAGE, hkv, d), randn(1 + 8 * ns, PAGE, hkv, d)
    tab = ((torch.randperm(8 * ns, generator=gen, device="cuda") + 1)
           .reshape(8, ns).to(torch.int32))
    for exp in EXPS:
        pol = ExecPolicy(exp_backend=exp, block_k=512, block_page=PAGE)
        outs = {
            ("flash_attention", "wave"): (
                fa.flash_attention(q, k, v, kv_len=kv_len, policy=pol),
                fa.flash_attention_plain(
                    q, k, v, kv_len=kv_len, block_k=512, exp_backend=exp),
                real),
            ("decode_attention", "bshd"): (
                da.decode_attention(qd, kc, vc, cl, policy=pol),
                da.decode_attention_plain(
                    qd, kc, vc, cl, block_s=pol.block_s, exp_backend=exp),
                None),
            ("decode_attention_paged", "bshd"): (
                da.decode_attention_paged(qd, kp, vp, tab, cl, policy=pol),
                da.decode_attention_paged_plain(
                    qd, kp, vp, tab, cl, exp_backend=exp),
                None)}
        for (kernel, case), (out, ref, rl) in outs.items():
            line(kernel, f"d120 {case}", "key_major", exp,
                 *reading(out, ref, rl))


def main():
    if not torch.cuda.is_available():
        sys.exit("[d128_order] no CUDA device")
    if sys.argv[1:] == ["--d", "120"]:
        order_d120()
        kernels_d120()
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--design":
        decode_order(sys.argv[2])
        return
    paths = build.build_all(["flash_attention.cu"])
    log = paths["flash_attention.cu"].with_suffix(".log").read_text()
    print(json.dumps({"ptxas": "flash_attention.cu", "fa_rows": [
        ln for ln in log.splitlines()
        if re.search(r"fa_rows_kernel|spill|registers", ln)][:60]}),
        flush=True)
    fa_order()
    build_designs()
    for design in DESIGNS:
        if subprocess.run([sys.executable, __file__, "--design", design],
                          cwd=ROOT).returncode != 0:
            sys.exit(f"[d128_order] design {design} failed")


if __name__ == "__main__":
    main()
