"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, times each eagerly
and as a CUDA graph of back-to-back calls (device time without the
wrapper's host work) beside its plain version, its library call and its
bound (the decode kernels also per CUDA kernel, from torch.profiler, and
at batch 1; the exp kernel per backend and dtype beside torch.exp, with
its SASS instructions per element from ``cuobjdump -sass``), serves
full-width gpt2-small through the port's ``Server`` on the contiguous
cache and on the paged pool with a shared-prefix cache (each group's
decode step as one CUDA graph, and eagerly, in turns; the replays held
to the eager step by the capture audit), both again with chunked
prefill (each group's chunk program a second CUDA graph; tokens held to
the monolithic serves'), a chaos serve (paged, chunked, a seeded fault
injector at all six points, a squeezed page budget, the degradation
ladder, a cancel and a deadline), then serves it sequence-sharded (``kv_mode="seq"``) on 2 ranks spawned on the
one card (gloo, host-staged collectives), then self-speculatively on both
pools (spec_k = 4, drafts under vexp_hw, verify "scan" and "chunk",
each burst k draft-step replays and one verify replay; scan tokens held
to the plain serves' request by request, chunk tokens up to a near
tie, the hw group's own-backend drafts as a control), and checks what
comes out.
Every phase prints one JSON line; the first failure on any rank exits
non-zero.
The last two lines are the kernel table and the device line. Without a
CUDA device, or without the rest of the checkout, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): the bound each kernel's
# time is held against.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
# f32 / int operations per element of vexp_f32's datapath (scale, floor,
# subtract, two polynomial branches, select, exponent add, four saturation
# selects), used only for the softmax phase's bound; the vexp phase counts
# the instructions of the built library's SASS instead.
VEXP_OPS_PER_ELEM = 20

# The attention kernels' limits against their plain versions (max |err|,
# share of bf16 outputs changed) are ATT_LIMITS in
# src/repro_torch/kernels/limits.py, with the card's readings behind them.

# Fused softmax kernel vs its plain version, largest distance in f32 ulps
# per exp backend. Both take the same row max (exact) and the same exp
# (vexp / vexp_hw bitwise, exact within the 0 ulp the vexp phase reads),
# but sum the row in another order, so 1/sum, and with it every output of
# the row, moves by a few ulps.
SOFTMAX_MAX_ULP = {"exact": 16, "vexp": 16, "vexp_hw": 16}
SOFTMAX_SIZES = (128, 512, 2048, 8192)      # benchmarks/softmax_speed.py
PAGE = 64                                   # gpt2-small's block_page


def fail(msg: str):
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn()`` from CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_time_ms(fn, iters=20, warmup=3, replays=5) -> float:
    """Device time per call of ``fn()`` without the host: ``iters`` calls
    captured in one CUDA graph after ``warmup`` eager calls on the capture
    stream, the graph replayed ``replays`` times between CUDA events.
    Raises if the calls cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def graph_ms(fn, what, iters=20):
    """``cuda_graph_time_ms``, or None after a line that says which call
    could not be captured and why."""
    try:
        return cuda_graph_time_ms(fn, iters)
    except Exception as e:          # noqa: BLE001 - reported, cell empty
        torch.cuda.synchronize()
        print(f"[chip_smoke] {what}: not captured in a CUDA graph, no "
              f"graph_ms: {type(e).__name__}: {e}", flush=True)
        return None


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def nan_aware_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: same bits, or both NaN (CUDA's bf16 rounding makes
    0x7FFF where torch makes 0x7FC0; both are NaN)."""
    if a.dtype == torch.bfloat16:
        same = a.view(torch.int16) == b.view(torch.int16)
    else:
        same = a.view(torch.int32) == b.view(torch.int32)
    return same | (torch.isnan(a) & torch.isnan(b))


def f32_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ulps between two finite-or-inf f32 tensors of the same sign."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def kernel_vs_plain(out, ref, real=None):
    """(max |out - ref|, share of outputs whose bits differ) over the
    outputs that the boolean ``real`` (broadcast to ``out``) selects."""
    o, r = out.float(), ref.float()
    if real is not None:
        sel = real.expand_as(o)
        o, r = o[sel], r[sel]
    return float((o - r).abs().max()), float((o != r).double().mean())


def check_attention(kernel, readings, where=""):
    """Fail unless every backend's kernel reading is inside ATT_LIMITS and
    every negative control is outside them: the plain version at half the
    online-update unit (block or page), for the decode kernels the
    textbook split-KV merge (``textbook_partial``), and for FA the scan
    with p in two bf16 terms against the same scan with p exact.
    ``readings`` maps (exp, "kernel" | "half_block" | "half_page" |
    "textbook_merge" | "p_two_terms") to (max_abs_err,
    mismatch_share)."""
    from repro_torch.kernels.limits import ATT_LIMITS
    for (exp, who), (err, share) in readings.items():
        lim_err, lim_share = ATT_LIMITS[kernel][exp]
        inside = err <= lim_err and share <= lim_share
        if who == "kernel" and not inside:
            fail(f"{kernel}{where} {exp}: kernel off its plain version by "
                 f"{err} (limit {lim_err}), {share} of outputs differ "
                 f"(limit {lim_share})")
        if who != "kernel" and inside:
            fail(f"{kernel}{where} {exp}: the negative control {who} passes "
                 f"the limits ({err}, {share}); they cannot see that fault")


def textbook_partial(q, k_cache, v_cache, cache_len, seq_offset, *, layout,
                     exp):
    """Negative control for the split decode kernels: the usual split-KV
    merge over the same 64-key tiles (each update block's keys from its
    start in steps of 64; the slice and the block are whole tiles here),
    each tile's p taken against the tile's own max and the tiles folded
    with one exp(m_t - m) each. Under vexp and vexp_hw
    exp(a) * exp(b) != exp(a + b), so this is another function than the
    plain sweep's running max per update block. Returns the raw
    (m, l) (B,Hkv,G,1) and acc (B,Hkv,G,d), f32."""
    import math
    from repro_torch.core.attention import NEG_INF
    from repro_torch.core.vexp import get_exp_fn
    exp_fn = get_exp_fn(exp)
    kk, vv = ((k_cache, v_cache) if layout == "bhsd"
              else (k_cache.transpose(1, 2), v_cache.transpose(1, 2)))
    b, _, h, d = q.shape
    hkv, smax = kk.shape[1], kk.shape[2]
    g, nt = h // hkv, smax // 64
    if smax % 64:
        raise ValueError("textbook_partial takes whole 64-key tiles")
    qg = ((q.float() * (1.0 / math.sqrt(d))).to(kk.dtype).float()
          .reshape(b, hkv, g, d))
    keep = ((seq_offset + torch.arange(smax, device=q.device))[None, :]
            < cache_len.reshape(-1, 1))[:, None, None]
    s = torch.where(keep, torch.einsum("bkgd,bktd->bkgt", qg, kk.float()),
                    NEG_INF).reshape(b, hkv, g, nt, 64)
    m_t = s.amax(-1)
    p = torch.where(keep.reshape(b, 1, 1, nt, 64),
                    exp_fn(s - m_t[..., None]), 0.0)
    pv_t = torch.einsum("bkgnt,bkntd->bkgnd", p.to(kk.dtype).float(),
                        vv.float().reshape(b, hkv, nt, 64, d))
    m = m_t.amax(-1)
    w = exp_fn(m_t - m[..., None])
    return (m[..., None], (w * p.sum(-1)).sum(-1)[..., None],
            (w[..., None] * pv_t).sum(-2))


def stage_device_us(fn, iters=20):
    """Device time per call of each kernel ``fn`` launches, by kernel
    name, in microseconds, from one torch.profiler window over ``iters``
    calls; "not measured" when the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0].removeprefix("void ")
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / iters)
    return by_name or "not measured"


def b1_reading(kernel, sdpa, nbytes, flops):
    """The B = 1 case (where a grid of one CTA per KV head and batch row
    had 12 CTAs): eager and graph ms of ``kernel`` and of the library
    call ``sdpa``, the bound, and the kernel's per-stage device time."""
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    return {"ms": cuda_time_ms(kernel, iters=50),
            "graph_ms": graph_ms(kernel, "kernel at B = 1", iters=50),
            "library_ms": cuda_time_ms(sdpa, iters=50),
            "library_graph_ms": graph_ms(sdpa, "sdpa at B = 1", iters=50),
            "bound_ms": b_ms, "bound_by": b_by,
            "stage_us": stage_device_us(kernel)}


# --------------------------------------------------------------- phases

def phase_build(kernels):
    t0 = time.perf_counter()
    paths = kernels.build_kernels()
    secs = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    ptxas = {src: [ln.strip() for ln in
                   p.with_suffix(".log").read_text().splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, p in paths.items()}
    emit({"phase": "build", "seconds": secs, "nvidia_smi": smi,
          "ptxas": ptxas})
    return smi


def all_f32_in(lo: float, hi: float, chunk: int):
    """Every f32 value in [lo, hi] (lo < 0 < hi), in chunks, on the card."""
    top = torch.tensor([hi], dtype=torch.float32).view(torch.int32).item()
    bot = torch.tensor([-lo], dtype=torch.float32).view(torch.int32).item()
    for sign, last in ((0, top), (1 << 31, bot)):
        for start in range(0, last + 1, chunk):
            bits = torch.arange(start, min(start + chunk, last + 1),
                                dtype=torch.int64, device="cuda")
            yield (bits | sign).to(torch.int32).view(torch.float32)


# SASS instruction kinds by opcode prefix (first match wins); anything
# else (moves, special registers, uniform-datapath and control
# instructions) is "other". Every kind takes an issue slot.
SASS_KINDS = (
    ("int", ("IADD", "IMAD", "IMUL", "LOP", "SHF", "SHL", "SHR", "ISETP",
             "IMNMX", "VIMNMX", "SEL", "PRMT", "LEA", "IABS", "BMSK",
             "FLO", "POPC", "BREV", "ICMP", "PLOP3", "P2R", "R2P")),
    ("fp32", ("FFMA", "FADD", "FMUL", "FSETP", "FSEL", "FMNMX", "FCHK",
              "FRND", "FSWZADD", "HFMA2", "HADD2", "HMUL2")),
    ("conv", ("F2I", "I2F", "F2F", "F2FP", "I2I", "MUFU")),
    ("mem", ("LD", "ST", "ATOM", "RED")),
)
STORE_BYTES = ((".128", 16), (".64", 8), (".U16", 2), (".S16", 2),
               (".U8", 1), (".S8", 1))
VEXP_SHAPE = (8 * 12 * 512, 512)        # B x H x S score rows of 512 keys
VEXP_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
EXP_BACKENDS = ("exact", "vexp", "vexp_hw")


def sass_functions(lib: str) -> dict:
    """{mangled kernel name: [(address, opcode, operands), ...]} from
    ``cuobjdump -sass`` of a built library, predicates stripped."""
    import shutil
    from pathlib import Path
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        tool = shutil.which("cuobjdump")
    if not tool:
        fail("cuobjdump not found beside nvcc: no SASS count")
    text = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m and cur is not None:
            ins = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip())
            op, _, args = ins.partition(" ")
            cur.append((int(m.group(1), 16), op, args))
    return funcs


def sass_per_element(instrs, elem_bytes: int):
    """Instructions of a kernel's largest loop (from a backward branch's
    target to the branch, NOPs aside) per element that the loop stores,
    by kind; None if the kernel has no such loop."""
    best = []
    for addr, op, args in instrs:
        targets = re.findall(r"0x[0-9a-f]+", args)
        if op.startswith("BRA") and targets:
            t = int(targets[-1], 16)
            if t <= addr:
                body = [i for i in instrs
                        if t <= i[0] <= addr and i[1] != "NOP"]
                if len(body) > len(best):
                    best = body
    stored = sum(next((b for sfx, b in STORE_BYTES if sfx in op), 4)
                 for _, op, _ in best if op.startswith("STG"))
    elems = stored // elem_bytes
    if not elems:
        return None
    per = {k: 0.0 for k, _ in SASS_KINDS}
    per["other"] = 0.0
    for _, op, _ in best:
        kind = next((k for k, pre in SASS_KINDS if op.startswith(pre)),
                    "other")
        per[kind] += 1.0 / elems
    per["total"] = len(best) / elems
    per["loop_elements"] = elems
    return per


def vexp_kernel_key(name: str):
    """(key "<form>_<backend>_<dtype>", element bytes) of a vexp library
    kernel by its mangled name, or None for another function. The
    computed form of vexp_hw in the shipped library is the loop of the
    table-building kernel (vexp_hw_bits on bf16 patterns, 8 a step)."""
    if "vexp_hw_table_build_kernel" in name:
        return "computed_vexp_hw_bf16", 2
    if "vexp_stream_kernel" not in name and "vexp_hw_table_kernel" not in name:
        return None
    f32 = "kernelIf" in name
    form = "computed" if "stream" in name else "table"
    m = re.search(r"Li(\d)E", name)
    exp = EXP_BACKENDS[int(m.group(1))] if m else "vexp_hw"
    return f"{form}_{exp}_{'f32' if f32 else 'bf16'}", 4 if f32 else 2


def vexp_sass_counts(lib=None) -> dict:
    """SASS instructions per element of each kernel of a built vexp
    library (the package's by default), keyed by ``vexp_kernel_key``."""
    from repro_torch.kernels import build
    out = {}
    for name, instrs in sass_functions(
            str(lib or build.lib_path("vexp.cu"))).items():
        key = vexp_kernel_key(name)
        if key is None:
            continue
        out[key[0]] = sass_per_element(instrs, key[1])
        if out[key[0]] is None:
            fail(f"vexp SASS: no counted loop in {name}")
    return out


def instr_bound_ms(per_elem: float, n: int, sms: int, clock_hz: float,
                   lanes: int) -> float:
    """Time to issue ``per_elem`` instructions for each of ``n`` elements
    at ``lanes`` lanes per SM per clock."""
    return per_elem * n / (sms * lanes * clock_hz) * 1e3


def max_clock_hz() -> float:
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(mhz) * 1e6


def check_vexp_case(kernels, kv, policy_cls, x, what):
    """The op on ``x`` for every backend against its plain version: vexp
    and vexp_hw bitwise (NaN-aware), exact within 2 ulps of x's dtype;
    each call one launch of the vexp kernel."""
    for exp in EXP_BACKENDS:
        before = kernels.launch_counts()["vexp"]
        out = kv.vexp(x, policy=policy_cls(exp_backend=exp))
        torch.cuda.synchronize()
        if kernels.launch_counts()["vexp"] != before + 1:
            fail(f"vexp {what} {exp}: not one launch of the kernel")
        ref = kv.vexp_plain(x, exp)
        if out.shape != x.shape or out.dtype != x.dtype:
            fail(f"vexp {what} {exp}: {out.shape} {out.dtype} out")
        if exp == "exact":
            ints = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
            o, r = out.reshape(-1), ref.reshape(-1)
            nan = torch.isnan(o)
            if not torch.equal(nan, torch.isnan(r)):
                fail(f"vexp {what} exact: NaNs differ from torch.exp")
            d = int((o.view(ints).long() - r.view(ints).long())[~nan]
                    .abs().max()) if bool((~nan).any()) else 0
            if d > 2:
                fail(f"vexp {what} exact: {d} ulp from torch.exp (limit 2)")
        else:
            bad = int((~nan_aware_equal(out, ref)).sum())
            if bad:
                fail(f"vexp {what} {exp}: {bad} of {x.numel()} differ")


def vexp_edge_cases(kernels, kv, policy_cls) -> dict:
    """Views at odd offsets (unaligned pointers), every tail length, one
    element, a non-contiguous view, and the device table: each held to
    its plain version."""
    g = torch.Generator(device="cuda").manual_seed(5)
    special = torch.tensor(
        [float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1e-45,
         -1e-45, 1e-39, -126.0 * 0.6931471805599453,
         128.0 * 0.6931471805599453, 88.7, -87.4, 200.0, -200.0],
        device="cuda")
    cases = 0
    for dname, dt in VEXP_DTYPES.items():
        base = (torch.randn(100_004, generator=g, device="cuda") * 4.0
                ).to(dt)
        base[1:1 + special.numel()] = special.to(dt)
        for off in (1, 3):                        # odd element offsets
            x = base[off:]
            if x.data_ptr() % 16 == 0:
                fail(f"vexp unaligned case {dname}: pointer is aligned")
            check_vexp_case(kernels, kv, policy_cls, x,
                            f"{dname} view at offset {off}")
            cases += 1
        for n in list(range(1, 8)) + [8 * 1000 + r for r in range(8)]:
            check_vexp_case(kernels, kv, policy_cls, base[:n].clone(),
                            f"{dname} n={n}")
            cases += 1
        for x in (base[:1].clone(), base[1].clone(),
                  base[:64].reshape(2, 4, 8)[:, 1:3, :]):
            check_vexp_case(kernels, kv, policy_cls, x,
                            f"{dname} shape {tuple(x.shape)}")
            cases += 1
    table = kv.vexp_hw_table(torch.device("cuda"))
    if not torch.equal(table.cpu(), kv.vexp_table_plain()):
        fail("vexp_hw table on the card != vexp_table_plain()")
    builds = kernels.launch_counts()["vexp_hw_table"]
    if builds != 1:
        fail(f"vexp_hw table built {builds} times on one device")
    return {"edge_cases": cases, "table_equal_plain": True,
            "table_builds": builds}


def phase_vexp(kernels, policy_cls):
    from repro_torch.kernels import vexp as kv
    res = {}
    # bf16: all 65,536 bit patterns, bitwise, every backend but exact
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device="cuda")
    xb = bits.to(torch.int16).view(torch.bfloat16)
    for exp in ("vexp_hw", "vexp"):
        pol = policy_cls(exp_backend=exp)
        out, ref = kv.vexp(xb, policy=pol), kv.vexp_plain(xb, exp)
        bad = int((~nan_aware_equal(out, ref)).sum())
        res[f"bf16_{exp}_mismatches"] = bad
        if bad:
            fail(f"vexp {exp} bf16: {bad} of 65536 patterns differ")
    # f32: every value in [-130, 130] (~2.25e9), vexp bitwise, exact <= 2 ulp
    n = 0
    worst = {"vexp": 0, "vexp_hw": 0, "exact": 0}
    for x in all_f32_in(-130.0, 130.0, 1 << 27):
        n += x.numel()
        for exp in worst:
            out = kv.vexp(x, policy=policy_cls(exp_backend=exp))
            ref = kv.vexp_plain(x, exp)
            if exp == "exact":
                d = int(f32_ulp_distance(out, ref).max())
            else:
                d = int((~nan_aware_equal(out, ref)).sum())
            worst[exp] = max(worst[exp], d)
    res.update({"f32_values": n, "f32_vexp_mismatches": worst["vexp"],
                "f32_vexp_hw_mismatches": worst["vexp_hw"],
                "f32_exact_max_ulp": worst["exact"]})
    if worst["vexp"] or worst["vexp_hw"]:
        fail(f"vexp f32 sweep: mismatches {worst}")
    if worst["exact"] > 2:
        fail(f"exact exp: {worst['exact']} ulp from torch.exp (limit 2)")
    res.update(vexp_edge_cases(kernels, kv, policy_cls))

    # the exp op, dispatch("vexp"), on a score-sized f32 tensor: parity and
    # time only. Serving does not call it (the attention kernels inline
    # the same exp), so the kernel table takes its launches, 0, from the
    # serve run like every other row's.
    from repro_torch.kernels import dispatch
    g = torch.Generator(device="cuda").manual_seed(0)
    x32 = torch.randn(VEXP_SHAPE, generator=g, device="cuda") * 4.0
    pol = policy_cls(exp_backend="vexp")
    kernels.reset_launch_counts()
    y = dispatch("vexp", pol)(x32, policy=pol)
    torch.cuda.synchronize()
    if kernels.launch_counts()["vexp"] != 1:
        fail("the vexp op did not launch the vexp kernel once")
    err = float((y - kv.vexp_plain(x32, "vexp")).abs().max())

    # every backend x dtype at the smoke shape: eager and graph ms beside
    # torch.exp of the same dtype (graph ms taken in turns with it), the
    # byte bound, and the instruction bounds from the library's SASS
    sass = vexp_sass_counts()
    want = {f"computed_{e}_{d}" for e in ("exact", "vexp")
            for d in VEXP_DTYPES}
    want |= {f"table_vexp_hw_{d}" for d in VEXP_DTYPES}
    want.add("computed_vexp_hw_bf16")
    if set(sass) != want:
        fail(f"vexp SASS: kernels {sorted(sass)}, expected {sorted(want)}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_clock_hz()
    n = x32.numel()
    readings = {}
    for dname, dt in VEXP_DTYPES.items():
        x = x32.to(dt)
        byte_ms = n * x.element_size() * 2 / HBM_BYTES_PER_S * 1e3
        pols = {exp: policy_cls(exp_backend=exp) for exp in EXP_BACKENDS}
        calls = {"torch.exp": lambda: torch.exp(x)}
        calls.update({exp: (lambda p=pols[exp]: kv.vexp(x, policy=p))
                      for exp in EXP_BACKENDS})
        # graph ms in turns, library call and kernels forward then back,
        # after one turn not kept (a dtype's first captures read slow)
        for k in calls:
            graph_ms(calls[k], f"{k} {dname}", iters=20)
        turns = {k: [] for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            turns[k].append(graph_ms(calls[k], f"{k} {dname}", iters=20))
        g_ms = {k: (None if None in t else sum(t) / len(t))
                for k, t in turns.items()}
        lib_ms = cuda_time_ms(calls["torch.exp"])
        for exp in EXP_BACKENDS:
            out, ref = calls[exp](), kv.vexp_plain(x, exp)
            form = "table" if exp == "vexp_hw" else "computed"
            per = sass[f"{form}_{exp}_{dname}"]
            r = {"ms": cuda_time_ms(calls[exp]), "graph_ms": g_ms[exp],
                 "graph_ms_turns": turns[exp],
                 "plain_ms": cuda_time_ms(lambda: kv.vexp_plain(x, exp),
                                          iters=5),
                 "library_ms": lib_ms,
                 "library_graph_ms": g_ms["torch.exp"],
                 "library_graph_ms_turns": turns["torch.exp"],
                 "byte_bound_ms": byte_ms,
                 "max_abs_err": float((out.float() - ref.float()).abs()
                                      .max()),
                 "form": form, "instr_per_elem": per}
            for lanes in (64, 128):
                r[f"instr_bound_ms_{lanes}"] = instr_bound_ms(
                    per["total"], n, sms, clock, lanes)
            if exp == "vexp_hw":
                comp = sass["computed_vexp_hw_bf16"]
                r["computed_instr_per_elem"] = comp
                for lanes in (64, 128):
                    r[f"computed_instr_bound_ms_{lanes}"] = instr_bound_ms(
                        comp["total"], n, sms, clock, lanes)
            readings[f"{exp}_{dname}"] = r
        del x
    res.update({"shape": list(VEXP_SHAPE), "sms": sms,
                "max_sm_clock_hz": clock, "readings": readings})
    emit({"phase": "vexp", **res})
    head = readings["vexp_f32"]           # the row's own numbers: vexp, f32
    b_ms = max(head["byte_bound_ms"], head["instr_bound_ms_128"])
    return {"name": "vexp_2d", "route": "cuda",
            "source": "src/repro_torch/csrc/vexp.cu",
            "replaces": "src/repro/kernels/vexp/kernel.py:33",
            "launches": None, "max_abs_err": err, "ms": head["ms"],
            "graph_ms": head["graph_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": b_ms,
            "bound_by": ("bytes" if head["byte_bound_ms"] >= b_ms
                         else "operations"),
            "library_ms": head["library_ms"],
            "library_graph_ms": head["library_graph_ms"],
            "readings": {k: {f: v[f] for f in (
                "form", "ms", "graph_ms", "library_graph_ms",
                "byte_bound_ms", "instr_bound_ms_64", "instr_bound_ms_128")}
                for k, v in readings.items()}}


def phase_softmax(policy_cls):
    """Kernel B4, the paper's Softmax, on S x S f32 attention scores for S
    in benchmarks/softmax_speed.py's sweep: the kernel against its plain
    version per exp backend (f32 ulps), timed against torch.softmax and
    its bound (one read plus one write of the scores)."""
    from repro_torch.kernels import softmax as ks
    g = torch.Generator(device="cuda").manual_seed(3)
    res, worst_err, row = {}, 0.0, None
    for s in SOFTMAX_SIZES:
        x = torch.randn(s, s, generator=g, device="cuda") * 4.0
        for exp in ("exact", "vexp", "vexp_hw"):
            pol = policy_cls(exp_backend=exp)
            out = ks.softmax(x, -1, policy=pol)
            ref = ks.softmax_plain(x, -1, exp_backend=exp)
            ulp = int(f32_ulp_distance(out, ref).max())
            err = float((out - ref).abs().max())
            worst_err = max(worst_err, err)
            res[f"s{s}_{exp}_max_ulp"] = ulp
            res[f"s{s}_{exp}_max_abs_err"] = err
            res[f"s{s}_{exp}_row_sum_max_dev"] = float(
                (out.double().sum(-1) - 1.0).abs().max())
            if ulp > SOFTMAX_MAX_ULP[exp]:
                emit({"phase": "softmax", **res})
                fail(f"softmax S={s} {exp}: kernel {ulp} ulp from its plain "
                     f"version (limit {SOFTMAX_MAX_ULP[exp]})")
        for exp in ("exact", "vexp_hw", "vexp"):    # vexp last: the row's ms
            pol = policy_cls(exp_backend=exp)
            res[f"s{s}_ms_{exp}"] = cuda_time_ms(
                lambda: ks.softmax(x, -1, policy=pol))
        ms = res[f"s{s}_ms_vexp"]
        plain_ms = cuda_time_ms(
            lambda: ks.softmax_plain(x, -1, exp_backend="vexp"), iters=5)
        lib_ms = cuda_time_ms(lambda: torch.softmax(x, -1))
        g_ms = graph_ms(lambda: ks.softmax(x, -1, policy=pol),
                        f"softmax_rows S={s}", iters=10)
        lib_g_ms = graph_ms(lambda: torch.softmax(x, -1),
                            f"torch.softmax S={s}", iters=10)
        b_ms, b_by = bound_ms(x.numel() * 8, x.numel() * VEXP_OPS_PER_ELEM,
                              F32_FLOP_PER_S)
        res.update({f"s{s}_plain_ms_vexp": plain_ms,
                    f"s{s}_library_ms": lib_ms, f"s{s}_graph_ms": g_ms,
                    f"s{s}_library_graph_ms": lib_g_ms,
                    f"s{s}_bound_ms": b_ms, f"s{s}_bound_by": b_by})
        row = (ms, g_ms, plain_ms, lib_ms, lib_g_ms, b_ms, b_by)  # largest S
        del x
    emit({"phase": "softmax", "sizes": list(SOFTMAX_SIZES), **res})
    ms, g_ms, plain_ms, lib_ms, lib_g_ms, b_ms, b_by = row
    return {"name": "softmax_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/softmax.cu",
            "replaces": "src/repro/kernels/softmax/kernel.py:41",
            "launches": None, "max_abs_err": worst_err, "ms": ms,
            "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "library_graph_ms": lib_g_ms}


def _qpos(sq, q_offset):
    """(1|B, Sq) absolute query positions: query i of row b sits at
    q_offset + i, q_offset an int or a (B,) tensor of per-row offsets."""
    off = torch.as_tensor(q_offset, device="cuda").reshape(-1, 1)
    return torch.arange(sq, device="cuda")[None, :] + off


def _sdpa_mask_prefill(kv_len, sq, sk, q_offset=0):
    qpos = _qpos(sq, q_offset)[:, :, None]
    kpos = torch.arange(sk, device="cuda")[None, None, :]
    return ((kpos <= qpos) & (kpos < kv_len[:, None, None]))[:, None]


def _scan_p_terms(q, k, v, kv_len, q_offset, block_k, exp, terms):
    """The plain scan (causal, keys below kv_len, queries at q_offset + i)
    with p rounded to its ``terms`` leading bf16 terms in p . v: what a
    tensor-core kernel that splits p too few times computes."""
    from repro_torch.core.vexp import get_exp_fn
    exp_fn = get_exp_fn(exp)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qs = q.float().transpose(1, 2) * (1.0 / d ** 0.5)   # (B, H, Sq, D)
    qpos = _qpos(sq, q_offset)[:, None, :, None]      # (1|B, 1, Sq, 1)
    m = torch.full((b, h, sq), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, sk, block_k):
        kb = k[:, k0:k0 + block_k].float().transpose(1, 2)
        vb = v[:, k0:k0 + block_k].float().transpose(1, 2)
        kpos = k0 + torch.arange(kb.shape[2], device=q.device)
        keep = (kpos <= qpos) & (kpos < kv_len[:, None, None, None])
        sc = torch.where(keep, qs @ kb.transpose(-1, -2), -1e30)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = exp_fn(m - m_new)
        p = torch.where(keep, exp_fn(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        pt, r = torch.zeros_like(p), p
        for _ in range(terms):
            t = r.to(torch.bfloat16).float()
            pt, r = pt + t, r - t
        acc = acc * alpha[..., None] + pt @ vb
        m = m_new
    out = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _truth64(q, k, v, kv_len, q_offset):
    """Causal attention under the exact exp in float64, one pass, rounded
    to bf16 once: what an exact evaluation of the function gives."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    sc = qd @ kd.transpose(-1, -2) * (1.0 / d ** 0.5)
    qpos = _qpos(sq, q_offset)[:, None, :, None]      # (1|B, 1, Sq, 1)
    kpos = torch.arange(sk, device=q.device)
    keep = (kpos <= qpos) & (kpos < kv_len[:, None, None, None])
    sc = torch.where(keep, sc, -1e300)
    p = torch.where(keep, torch.exp(sc - sc.amax(-1, keepdim=True)), 0.0)
    out = (p @ vd) / p.sum(-1, keepdim=True).clamp_min(1e-300)
    return out.transpose(1, 2).to(q.dtype)


def _fa_case(fa, policy_cls, block_k, q, k, v, kv_len, q_offset, tag):
    """One FA case. The kernel vs the plain version per backend, and the
    plain version at half the block and with p in two bf16 terms (both
    must fail the limits); under the exact exp, both the kernel and the
    plain version vs a float64 evaluation (reported). Times (eager and
    graph), the library call's and the bound. Query i of row b sits at
    q_offset + i; its real rows are those below kv_len[b]. Returns
    (fields, limit readings)."""
    b, sq, h, d = q.shape
    qpos = _qpos(sq, q_offset)
    real = (qpos < kv_len[:, None])[:, :, None, None]
    kw = dict(causal=True, kv_len=kv_len, q_offset=q_offset)
    res, readings = {}, {}
    for exp in ("exact", "vexp", "vexp_hw"):
        pol = policy_cls(exp_backend=exp, block_k=block_k)
        out = fa.flash_attention(q, k, v, policy=pol, **kw)
        ref = fa.flash_attention_plain(q, k, v, block_k=block_k,
                                       exp_backend=exp, **kw)
        readings[exp, "kernel"] = kernel_vs_plain(out, ref, real)
        if exp != "exact":       # exact exp: the partition moves only ulps
            half = fa.flash_attention_plain(q, k, v, block_k=block_k // 2,
                                            exp_backend=exp, **kw)
            readings[exp, "half_block"] = kernel_vs_plain(half, ref, real)
        if exp != "vexp_hw":     # vexp_hw's p is one bf16 term already
            # against the same scan with p in three terms (p exactly), so
            # that the rounding of p is the only difference
            two, three = (_scan_p_terms(q, k, v, kv_len, q_offset, block_k,
                                        exp, n) for n in (2, 3))
            readings[exp, "p_two_terms"] = kernel_vs_plain(two, three, real)
        if exp == "exact":
            truth = _truth64(q, k, v, kv_len, q_offset)
            for who, o in (("plain", ref), ("kernel", out)):
                res[f"{tag}exact_{who}_vs_f64_mismatch_share"] = \
                    kernel_vs_plain(o, truth, real)[1]
    for (exp, who), (err, share) in readings.items():
        res[f"{tag}{exp}_{who}_max_abs_err"] = err
        res[f"{tag}{exp}_{who}_mismatch_share"] = share
    for exp in ("exact", "vexp_hw", "vexp"):      # vexp last: the row's ms
        pol = policy_cls(exp_backend=exp, block_k=block_k)
        res[f"{tag}ms_{exp}"] = cuda_time_ms(
            lambda: fa.flash_attention(q, k, v, policy=pol, **kw))
    res[f"{tag}graph_ms_vexp"] = graph_ms(
        lambda: fa.flash_attention(q, k, v, policy=pol, **kw),
        f"flash_attention {tag}")
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
        q, k, v, block_k=block_k, exp_backend="vexp", **kw), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = _sdpa_mask_prefill(kv_len, sq, k.shape[1], q_offset)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)
    lib_ms = cuda_time_ms(sdpa)
    lib_g_ms = graph_ms(sdpa, f"sdpa {tag}")
    # the function's work: every query row attends, causally, to the keys
    # below its row's kv_len; q and o move whole, K and V up to kv_len
    pairs = float(torch.minimum(qpos.double() + 1,
                                kv_len.double()[:, None]).sum())
    flops = 4.0 * h * d * pairs
    live = float(kv_len.double().sum())
    nbytes = 2 * b * sq * h * d * 2 + 2 * live * h * d * 2
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    res.update({f"{tag}plain_ms_vexp": plain_ms, f"{tag}library_ms": lib_ms,
                f"{tag}library_graph_ms": lib_g_ms,
                f"{tag}bound_ms": b_ms, f"{tag}bound_by": b_by,
                f"{tag}kv_len": kv_len.tolist()})
    if not isinstance(q_offset, int):
        res[f"{tag}q_offset"] = q_offset.tolist()
    return res, readings


SPEC_K = 4                     # draft tokens a burst: W = 5 lanes
VERIFY_DRAWS = 8               # independent inputs of the verify case


def _fa_verify_case(fa, policy_cls, block_k):
    """The chunk verify's call: B=8 rows of W = SPEC_K + 1 queries over
    the 1,024-row cache, per-row offsets a (B,) device tensor with a row
    at the cap (1,024: no lane of room, kv_len 1,024), one with 3 lanes
    of room, a dead row (no lane; kv_len its cursor) and rows crossing
    block_k boundaries; kv_len = offset + lanes, as the verify passes
    them. Held to ATT_LIMITS per backend over VERIFY_DRAWS independent
    draws of q, K and V, pooled (one draw has ~21,500 real outputs, so a
    single one-ulp flip would read 4.6e-5 against the 3e-5 share limit;
    the pooled share is the kernel's rate).

    The plain version is evaluated with its queries padded to the
    kernel's 64-row tile (zero rows after the W real ones, dropped
    after): the same function, since rows are independent, but the f32
    matrix products then run at the row count the limits were read at.
    At 5 rows the card's library picks another summation order for the
    plain version's own products, and the plain version at 5 rows
    against itself at 64 is reported (``plain_rows_vs_padded``) beside
    the kernel against each, and both against a float64 evaluation under
    the exact exp. The negative controls are reported, not held: at 5
    queries a row the two-term p moves too few outputs to show. Times on
    draw 0 against SDPA and the bound. Returns (fields, kernel limit
    readings)."""
    b, w, sk, h, d = 8, SPEC_K + 1, 1024, 12, 64
    offs = torch.tensor([0, 1024, 1021, 300, block_k - 2, 600, 511, 1019],
                        dtype=torch.int32, device="cuda")
    lanes = torch.clamp(sk - offs, 0, w)
    lanes[3] = 0                                       # the dead row
    kv = offs + lanes
    g = torch.Generator(device="cuda").manual_seed(11)
    draws = [tuple(torch.randn(b, n, h, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for n in (w, sk, sk))
             for _ in range(VERIFY_DRAWS)]
    real = (_qpos(w, offs) < kv[:, None])[:, :, None, None]
    kw = dict(causal=True, kv_len=kv, q_offset=offs)
    res, readings = {}, {}
    def padded(q):                     # the W rows, then zeros to 64
        return torch.cat([q, q.new_zeros(b, 64 - w, h, d)], dim=1)

    sel = real.expand(b, w, h, d)
    for exp in ("exact", "vexp", "vexp_hw"):
        pol = policy_cls(exp_backend=exp, block_k=block_k)
        outs, refs, rows = [], [], []
        for q, k, v in draws:
            outs.append(fa.flash_attention(q, k, v, policy=pol, **kw)[sel])
            refs.append(fa.flash_attention_plain(
                padded(q), k, v, block_k=block_k, exp_backend=exp,
                **kw)[:, :w][sel])
            rows.append(fa.flash_attention_plain(
                q, k, v, block_k=block_k, exp_backend=exp, **kw)[sel])
        o, r, r5 = torch.cat(outs), torch.cat(refs), torch.cat(rows)
        readings[exp, "kernel"] = kernel_vs_plain(o, r)
        res[f"verify_{exp}_kernel_max_abs_err"] = readings[exp, "kernel"][0]
        res[f"verify_{exp}_kernel_mismatch_share"] = \
            readings[exp, "kernel"][1]
        res[f"verify_{exp}_kernel_vs_plain_rows_mismatch_share"] = \
            kernel_vs_plain(o, r5)[1]
        res[f"verify_{exp}_plain_rows_vs_padded_mismatch_share"] = \
            kernel_vs_plain(r5, r)[1]
        res[f"verify_{exp}_real_outputs"] = int(o.numel())
        if exp == "exact":
            truth = torch.cat([_truth64(q, k, v, kv, offs)[sel]
                               for q, k, v in draws])
            for who, t in (("kernel", o), ("plain", r), ("plain_rows", r5)):
                res[f"verify_exact_{who}_vs_f64_mismatch_share"] = \
                    kernel_vs_plain(t, truth)[1]
        else:
            half = torch.cat([fa.flash_attention_plain(
                padded(q), k, v, block_k=block_k // 2, exp_backend=exp,
                **kw)[:, :w][sel] for q, k, v in draws])
            res[f"verify_{exp}_half_block_mismatch_share"] = \
                kernel_vs_plain(half, r)[1]
    q, k, v = draws[0]
    pol = policy_cls(exp_backend="vexp", block_k=block_k)
    res["verify_ms_vexp"] = cuda_time_ms(
        lambda: fa.flash_attention(q, k, v, policy=pol, **kw))
    res["verify_graph_ms_vexp"] = graph_ms(
        lambda: fa.flash_attention(q, k, v, policy=pol, **kw),
        "flash_attention verify")
    res["verify_plain_ms_vexp"] = cuda_time_ms(
        lambda: fa.flash_attention_plain(q, k, v, block_k=block_k,
                                         exp_backend="vexp", **kw), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = _sdpa_mask_prefill(kv, w, sk, offs)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)
    res["verify_library_ms"] = cuda_time_ms(sdpa)
    res["verify_library_graph_ms"] = graph_ms(sdpa, "sdpa verify")
    pairs = float(torch.minimum(_qpos(w, offs).double() + 1,
                                kv.double()[:, None]).sum())
    nbytes = 2 * b * w * h * d * 2 + 2 * float(kv.double().sum()) * h * d * 2
    res["verify_bound_ms"], res["verify_bound_by"] = bound_ms(
        nbytes, 4.0 * h * d * pairs, BF16_FLOP_PER_S)
    res["verify_q_offset"] = offs.tolist()
    res["verify_kv_len"] = kv.tolist()
    return res, readings


def phase_flash_attention(policy_cls, block_k):
    """Kernel 3 at gpt2-small prefill shapes: B=8, H=12, D=64, Sq=Sk=512,
    ragged kv_len in [32, 512], causal; the hot-prefix case of suffix
    admission: 256 suffix queries at q_offset=256 over 512 keys (history
    + suffix), ragged kv_len in [257, 512]; and a D = 32 case (the
    reduced config's heads: B=8, H=4, S=512, block_k 128, the policy
    default, so rows walk several blocks) for the kernel's D = 32 path;
    and the chunk program's call: 128 chunk queries over the 1,024-row
    cache at per-row offsets given as a (B,) device tensor (0, one
    chunk crossing a block_k boundary, 896, two inert rows with no
    tokens, one of them at offset 0 and so with no key at all, ...),
    kv_len = offset + tokens. The plain version computed on the host is
    also read against itself on the card, to show the order noise the
    limits leave no room for."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(1)
    b, s, h, d = 8, 512, 12, 64
    q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    kv_len = torch.randint(32, s + 1, (b,), generator=g, device="cuda",
                           dtype=torch.int32)
    kv_len[0] = s
    res, readings = _fa_case(fa, policy_cls, block_k, q, k, v, kv_len, 0,
                             "")
    # the plain version on the host against itself on the card
    host = fa.flash_attention_plain(
        q.cpu(), k.cpu(), v.cpu(), block_k=block_k, exp_backend="exact",
        causal=True, kv_len=kv_len.cpu()).cuda()
    card = fa.flash_attention_plain(q, k, v, block_k=block_k,
                                    exp_backend="exact", causal=True,
                                    kv_len=kv_len)
    real = (torch.arange(s, device="cuda")[None, :]
            < kv_len[:, None])[:, :, None, None]
    res["exact_plain_host_vs_card_mismatch_share"] = kernel_vs_plain(
        host, card, real)[1]
    off = s // 2
    qh = torch.randn(b, s - off, h, d, generator=g,
                     device="cuda").to(torch.bfloat16)
    kv_hot = torch.randint(off + 1, s + 1, (b,), generator=g, device="cuda",
                           dtype=torch.int32)
    kv_hot[0] = s
    hot, hot_readings = _fa_case(fa, policy_cls, block_k, qh, k, v, kv_hot,
                                 off, "hot_")
    res.update(hot)
    g32 = torch.Generator(device="cuda").manual_seed(6)
    b32, s32, h32, bk32 = 8, 512, 4, policy_cls().block_k
    q32, k32, v32 = (torch.randn(b32, s32, h32, 32, generator=g32,
                                 device="cuda").to(torch.bfloat16)
                     for _ in range(3))
    kv32 = torch.randint(32, s32 + 1, (b32,), generator=g32, device="cuda",
                         dtype=torch.int32)
    kv32[0] = s32
    d32, d32_readings = _fa_case(fa, policy_cls, bk32, q32, k32, v32, kv32,
                                 0, "d32_")
    res.update(d32)
    gc = torch.Generator(device="cuda").manual_seed(7)
    sq_c, sk_c = 128, 1024
    qc = torch.randn(b, sq_c, h, d, generator=gc,
                     device="cuda").to(torch.bfloat16)
    kc, vc = (torch.randn(b, sk_c, h, d, generator=gc, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    offs = torch.tensor([0, block_k - 64, 896, 0, 600, 128, 300, 768],
                        dtype=torch.int32, device="cuda")
    clens = torch.tensor([128, 128, 128, 0, 0, 100, 37, 128],
                         dtype=torch.int32, device="cuda")
    kv_c = offs + clens
    chunk, chunk_readings = _fa_case(fa, policy_cls, block_k, qc, kc, vc,
                                     kv_c, offs, "chunk_")
    res.update(chunk)
    # what the kernel writes for the row with no key (kv_len 0): neither
    # a cache row nor a token reads it; reported beside the plain version
    empty = kv_c == 0
    for exp in ("exact", "vexp", "vexp_hw"):
        pol = policy_cls(exp_backend=exp, block_k=block_k)
        kw = dict(causal=True, kv_len=kv_c, q_offset=offs)
        out = fa.flash_attention(qc, kc, vc, policy=pol, **kw)
        ref = fa.flash_attention_plain(qc, kc, vc, block_k=block_k,
                                       exp_backend=exp, **kw)
        res[f"chunk_{exp}_empty_row_kernel_max_abs"] = float(
            out[empty].float().abs().max())
        res[f"chunk_{exp}_empty_row_plain_max_abs"] = float(
            ref[empty].float().abs().max())
    verify, verify_readings = _fa_verify_case(fa, policy_cls, block_k)
    res.update(verify)
    emit({"phase": "flash_attention", "block_k": block_k, "hot_q_offset": off,
          "d32_block_k": bk32, **res})
    check_attention("flash_attention", readings)
    check_attention("flash_attention", hot_readings, " hot")
    check_attention("flash_attention", d32_readings, " D=32")
    check_attention("flash_attention", chunk_readings, " chunk")
    check_attention("flash_attention", verify_readings, " verify")
    worst = max(err for rd in (readings, hot_readings, d32_readings,
                               chunk_readings, verify_readings)
                for (_, who), (err, _) in rd.items() if who == "kernel")
    return {"name": "flash_attention_bhsd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:104",
            "launches": 0, "max_abs_err": worst, "ms": res["ms_vexp"],
            "graph_ms": res["graph_ms_vexp"], "plain_ms": res["plain_ms_vexp"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"],
            "library_graph_ms": res["library_graph_ms"],
            "chunk_shape": f"B={b} Sq={sq_c} Sk={sk_c} H={h} D={d}, (B,) "
                           f"q_offset tensor",
            **{f"chunk_{k}": res[f"chunk_{k}"] for k in (
                "ms_vexp", "graph_ms_vexp", "plain_ms_vexp", "bound_ms",
                "bound_by", "library_ms", "library_graph_ms")},
            "verify_shape": f"B={b} Sq={SPEC_K + 1} Sk=1024 H={h} D={d}, "
                            f"(B,) q_offset tensor",
            **{f"verify_{k}": res[f"verify_{k}"] for k in (
                "ms_vexp", "graph_ms_vexp", "plain_ms_vexp", "bound_ms",
                "bound_by", "library_ms", "library_graph_ms")}}


def phase_decode(policy_cls):
    """Kernel B2 at decode shapes: B=8, Hkv=12, G=1, d=64, S=1024, ragged
    cache_len, both cache layouts; the half-block and textbook-merge
    controls; the device time of each of its kernels (torch.profiler);
    and the B = 1 case beside SDPA's."""
    from repro_torch.kernels import decode_attention as da
    g = torch.Generator(device="cuda").manual_seed(2)
    b, s, h, d = 8, 1024, 12, 64
    q = torch.randn(b, 1, h, d, generator=g, device="cuda").to(torch.bfloat16)
    kc, vc = (torch.randn(b, s, h, d, generator=g, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    cache_len = torch.randint(33, s + 1, (b,), generator=g, device="cuda",
                              dtype=torch.int32)
    cache_len[0] = s
    res, worst, times, checks = {}, 0.0, {}, []
    for layout in ("bshd", "bhsd"):
        kl, vl = ((kc, vc) if layout == "bshd" else
                  (kc.transpose(1, 2).contiguous(),
                   vc.transpose(1, 2).contiguous()))
        readings = {}
        for exp in ("exact", "vexp", "vexp_hw"):
            pol = policy_cls(exp_backend=exp)
            out = da.decode_attention(q, kl, vl, cache_len, layout=layout,
                                      policy=pol)
            ref = da.decode_attention_plain(q, kl, vl, cache_len,
                                            layout=layout,
                                            block_s=pol.block_s,
                                            exp_backend=exp)
            readings[exp, "kernel"] = kernel_vs_plain(out, ref)
            if exp != "exact":
                half = da.decode_attention_plain(
                    q, kl, vl, cache_len, layout=layout,
                    block_s=pol.block_s // 2, exp_backend=exp)
                readings[exp, "half_block"] = kernel_vs_plain(half, ref)
                tb = textbook_partial(q, kl, vl, cache_len, 0,
                                      layout=layout, exp=exp)
                readings[exp, "textbook_merge"] = kernel_vs_plain(
                    _norm_stats(*tb).reshape(ref.shape), ref)
        for (exp, who), (err, share) in readings.items():
            res[f"{layout}_{exp}_{who}_max_abs_err"] = err
            res[f"{layout}_{exp}_{who}_mismatch_share"] = share
            if who == "kernel":
                worst = max(worst, err)
        checks.append((layout, readings))
        for exp in ("exact", "vexp_hw", "vexp"):
            pol = policy_cls(exp_backend=exp)
            res[f"ms_{layout}_{exp}"] = cuda_time_ms(
                lambda: da.decode_attention(q, kl, vl, cache_len,
                                            layout=layout, policy=pol),
                iters=50)
        times[layout] = (res[f"ms_{layout}_vexp"], cuda_time_ms(
            lambda: da.decode_attention_plain(
                q, kl, vl, cache_len, layout=layout, block_s=pol.block_s,
                exp_backend="vexp"), iters=10))
    qt = q.transpose(1, 2)
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(s, device="cuda")[None, :]
            < cache_len[:, None])[:, None, None]
    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)
    lib_ms = cuda_time_ms(sdpa, iters=50)
    lib_g_ms = graph_ms(sdpa, "sdpa (decode)", iters=50)
    pol = policy_cls(exp_backend="vexp")
    g_ms = graph_ms(lambda: da.decode_attention(q, kc, vc, cache_len,
                                                layout="bshd", policy=pol),
                    "decode_attention_kernel", iters=50)
    stage_us = stage_device_us(lambda: da.decode_attention(
        q, kc, vc, cache_len, layout="bshd", policy=pol))
    live = float(cache_len.double().sum())
    nbytes = live * h * d * 2 * 2 + 2 * b * h * d * 2   # K+V rows, q, o
    flops = 4.0 * live * h * d
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    # B = 1: row 0, whose cache is full
    live1 = float(cache_len[0])
    b1 = b1_reading(
        lambda: da.decode_attention(q[:1], kc[:1], vc[:1], cache_len[:1],
                                    layout="bshd", policy=pol),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt[:1], kt[:1], vt[:1], attn_mask=mask[:1]),
        live1 * h * d * 2 * 2 + 2 * h * d * 2, 4.0 * live1 * h * d)
    ms, plain_ms = times["bshd"]
    res.update({"plain_ms_bshd": plain_ms,
                "plain_ms_bhsd": times["bhsd"][1], "library_ms": lib_ms,
                "graph_ms_bshd_vexp": g_ms, "library_graph_ms": lib_g_ms,
                "bound_ms": b_ms, "bound_by": b_by,
                "stage_us_bshd_vexp": stage_us, "b1_bshd_vexp": b1,
                "cache_len": cache_len.tolist()})
    emit({"phase": "decode_attention", **res})
    for layout, readings in checks:
        check_attention("decode_attention", readings, f" {layout}")
    return {"name": "decode_attention_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:196",
            "launches": 0, "max_abs_err": worst, "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "library_graph_ms": lib_g_ms}


def phase_paged_decode(policy_cls):
    """Kernel B7 at gpt2-small decode shapes over a page pool: B=8,
    Hkv=12, G=1, d=64, page=64, 16 pages per row (1,024 keys) from a
    shuffled table, ragged cache_len in [37, 1024], both pool layouts;
    the half-page and textbook-merge controls; the device time of each
    of its kernels (torch.profiler); and the B = 1 case beside SDPA's."""
    from repro_torch.kernels import decode_attention as da
    g = torch.Generator(device="cuda").manual_seed(4)
    b, ns, h, d, page = 8, 16, 12, 64, PAGE
    n_pages = 1 + b * ns                     # page 0: the scratch page
    q = torch.randn(b, 1, h, d, generator=g, device="cuda").to(torch.bfloat16)
    kp, vp = (torch.randn(n_pages, page, h, d, generator=g, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    perm = torch.randperm(b * ns, generator=g, device="cuda") + 1
    tab = perm.reshape(b, ns).to(torch.int32)
    cache_len = torch.randint(37, ns * page + 1, (b,), generator=g,
                              device="cuda", dtype=torch.int32)
    cache_len[0] = ns * page
    # entries at or past a row's extent point at the scratch page, as the
    # engine's tables do; the kernel must not read them
    extent = (cache_len + page - 1) // page
    tab = torch.where(torch.arange(ns, device="cuda")[None, :]
                      < extent[:, None], tab, 0)
    res, worst, times, checks = {}, 0.0, {}, []
    for layout in ("bshd", "bhsd"):
        kl, vl = ((kp, vp) if layout == "bshd" else
                  (kp.transpose(1, 2).contiguous(),
                   vp.transpose(1, 2).contiguous()))
        readings = {}
        for exp in ("exact", "vexp", "vexp_hw"):
            pol = policy_cls(exp_backend=exp, block_page=page)
            out = da.decode_attention_paged(q, kl, vl, tab, cache_len,
                                            layout=layout, policy=pol)
            ref = da.decode_attention_paged_plain(q, kl, vl, tab, cache_len,
                                                  layout=layout,
                                                  exp_backend=exp)
            readings[exp, "kernel"] = kernel_vs_plain(out, ref)
            if exp != "exact":
                half = da.decode_attention_paged_plain(
                    q, kl, vl, tab, cache_len, layout=layout,
                    exp_backend=exp, block=page // 2)
                readings[exp, "half_page"] = kernel_vs_plain(half, ref)
                tb = textbook_partial(
                    q, da.paged_gather(kl, tab, layout),
                    da.paged_gather(vl, tab, layout), cache_len, 0,
                    layout=layout, exp=exp)
                readings[exp, "textbook_merge"] = kernel_vs_plain(
                    _norm_stats(*tb).reshape(ref.shape), ref)
        for (exp, who), (err, share) in readings.items():
            res[f"{layout}_{exp}_{who}_max_abs_err"] = err
            res[f"{layout}_{exp}_{who}_mismatch_share"] = share
            if who == "kernel":
                worst = max(worst, err)
        checks.append((layout, readings))
        for exp in ("exact", "vexp_hw", "vexp"):
            pol = policy_cls(exp_backend=exp, block_page=page)
            res[f"ms_{layout}_{exp}"] = cuda_time_ms(
                lambda: da.decode_attention_paged(q, kl, vl, tab, cache_len,
                                                  layout=layout, policy=pol),
                iters=50)
        times[layout] = (res[f"ms_{layout}_vexp"], cuda_time_ms(
            lambda: da.decode_attention_paged_plain(
                q, kl, vl, tab, cache_len, layout=layout,
                exp_backend="vexp"), iters=10))
    # library: SDPA over the cache already gathered contiguous through the
    # table; the gather is not timed
    kt = da.paged_gather(kp, tab).transpose(1, 2)
    vt = da.paged_gather(vp, tab).transpose(1, 2)
    qt = q.transpose(1, 2)
    mask = (torch.arange(ns * page, device="cuda")[None, :]
            < cache_len[:, None])[:, None, None]
    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)
    lib_ms = cuda_time_ms(sdpa, iters=50)
    lib_g_ms = graph_ms(sdpa, "sdpa (paged decode, gathered)", iters=50)
    pol = policy_cls(exp_backend="vexp", block_page=page)
    g_ms = graph_ms(lambda: da.decode_attention_paged(
        q, kp, vp, tab, cache_len, layout="bshd", policy=pol),
        "decode_attention_kernel_paged", iters=50)
    stage_us = stage_device_us(lambda: da.decode_attention_paged(
        q, kp, vp, tab, cache_len, layout="bshd", policy=pol))
    # the bound reads each row's live pages (K and V) once, q and o once;
    # the operations count the live keys
    live_pages = float(extent.double().sum())
    nbytes = live_pages * page * h * d * 2 * 2 + 2 * b * h * d * 2
    flops = 4.0 * float(cache_len.double().sum()) * h * d
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    # B = 1: row 0, whose 16 pages are all live
    live1 = float(cache_len[0])
    b1 = b1_reading(
        lambda: da.decode_attention_paged(q[:1], kp, vp, tab[:1],
                                          cache_len[:1], layout="bshd",
                                          policy=pol),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt[:1], kt[:1], vt[:1], attn_mask=mask[:1]),
        float(extent[0]) * page * h * d * 2 * 2 + 2 * h * d * 2,
        4.0 * live1 * h * d)
    ms, plain_ms = times["bshd"]
    res.update({"page": page, "plain_ms_bshd": plain_ms,
                "plain_ms_bhsd": times["bhsd"][1], "library_ms": lib_ms,
                "graph_ms_bshd_vexp": g_ms, "library_graph_ms": lib_g_ms,
                "library": "sdpa over the gathered contiguous cache "
                           "(gather not timed)",
                "live_pages": int(live_pages), "bound_ms": b_ms,
                "bound_by": b_by, "stage_us_bshd_vexp": stage_us,
                "b1_bshd_vexp": b1, "cache_len": cache_len.tolist()})
    emit({"phase": "decode_attention_paged", **res})
    for layout, readings in checks:
        check_attention("decode_attention_paged", readings, f" {layout}")
    return {"name": "decode_attention_kernel_paged", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention_paged.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:470",
            "launches": 0, "max_abs_err": worst, "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "library_graph_ms": lib_g_ms}


# Sequence-sharded decode: the fold of the shards' statistics against
# the unsharded kernel, the limit the reference holds its sharded decode
# to (tests/test_sharded_decode.py:276-309).
FOLD_LIMIT = 2e-3
SHARD_COUNTS = (2, 4)


def _norm_stats(m, l, acc):
    """A shard's own normalized output acc / max(l, 1e-30), in bf16."""
    return (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


def _fold_out(tiles, exp, q):
    """The merge's local fold of stacked shard tiles -> (B,1,H,d) bf16."""
    from repro_torch.core.softmax import stats_fold_packed
    from repro_torch.core.vexp import get_exp_fn
    st, acc = stats_fold_packed(torch.stack(tiles),
                                exp_fn=get_exp_fn(exp))
    return (acc / torch.clamp(st.l, min=1e-30)).reshape(q.shape).to(
        q.dtype)


def _sharded_case(kernel, kern, plain, textbook, unsharded, q, cache_len,
                  offsets, block, exps, policy_cls, problems):
    """One (kernel, layout, shard count) case. ``kern(mode, pol, r)`` runs
    shard r's partial ("partial" -> (m, l, acc)) or packed ("packed" ->
    tile) kernel, ``plain(exp, r, block)`` the partial plain version,
    ``textbook(exp, r)`` the textbook merge's statistics,
    ``unsharded(pol)`` the unsharded kernel. Checks the packed tile equal
    to the partial statistics bit for bit, empty rows at the identity,
    each shard's kernel against its plain version (both normalized per
    shard, live rows only) inside ATT_LIMITS[kernel] and the plain
    version at half the update unit and the textbook merge outside them,
    and the fold of the
    packed tiles within FOLD_LIMIT of the unsharded kernel; what fails is
    appended to ``problems``. Returns (readings, fold errors)."""
    from repro_torch.core.softmax import KERNEL_NEG_INF
    readings, fold = {}, {}
    for exp in exps:
        pol = policy_cls(exp_backend=exp)
        outs = {"kernel": [], "plain": [], "half_block": [],
                "textbook_merge": []}
        tiles = []
        for r, off in enumerate(offsets):
            live = cache_len > off
            m, l, acc = kern("partial", pol, r)
            tile = kern("packed", pol, r)
            tiles.append(tile)
            if not torch.equal(tile, torch.cat([acc, m, l], dim=-1)):
                problems.append(f"{kernel} {exp} shard {r}: packed tile != "
                                f"partial statistics")
            empty = ~live
            if empty.any() and not (
                    bool((m[empty] == KERNEL_NEG_INF).all())
                    and bool((l[empty] == 0).all())
                    and bool((acc[empty] == 0).all())):
                problems.append(f"{kernel} {exp} shard {r}: an empty row is "
                                f"not the merge identity "
                                f"({KERNEL_NEG_INF}, 0, 0)")
            outs["kernel"].append(_norm_stats(m, l, acc)[live])
            outs["plain"].append(_norm_stats(*plain(exp, r, block))[live])
            if exp != "exact":
                outs["half_block"].append(
                    _norm_stats(*plain(exp, r, block // 2))[live])
                outs["textbook_merge"].append(
                    _norm_stats(*textbook(exp, r))[live])
        ref = torch.cat(outs["plain"])
        for who in ("kernel", "half_block", "textbook_merge"):
            if outs[who]:
                readings[exp, who] = kernel_vs_plain(torch.cat(outs[who]),
                                                     ref)
        folded = _fold_out(tiles, exp, q)
        fold[exp] = float((folded.float()
                           - unsharded(pol).float()).abs().max())
        if fold[exp] > FOLD_LIMIT:
            problems.append(f"{kernel} {exp}: the fold of {len(offsets)} "
                            f"shards is {fold[exp]} off the unsharded "
                            f"kernel (limit {FOLD_LIMIT})")
    return readings, fold


def phase_sharded_decode(policy_cls):
    """Kernels B5 / B6 (contiguous) and B8 / B9 (paged) at the decode
    phase's shape, B=8, Hkv=12, G=1, d=64, S=1024, page 64, both layouts,
    the cache cut into 2 and 4 sequence slices, on one process: each
    shard's kernel against its plain version at its seq_offset, the
    empty-shard identity, the fold against the unsharded kernel, the
    overflow case (q x 60), the half-block and textbook-merge controls,
    per-shard times beside the bound, and the device time of each CUDA
    kernel a mode launches on shard 0 (torch.profiler)."""
    from repro_torch.kernels import decode_attention as da
    g = torch.Generator(device="cuda").manual_seed(5)
    b, s, h, d, page = 8, 1024, 12, 64, PAGE
    ns = s // page
    q = torch.randn(b, 1, h, d, generator=g, device="cuda").to(torch.bfloat16)
    kc, vc = (torch.randn(b, s, h, d, generator=g, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    # rows inside the first quarter, inside the first half (shard 1 of 2
    # empty), straddling the half, and full
    cache_len = torch.randint(33, s + 1, (b,), generator=g, device="cuda",
                              dtype=torch.int32)
    cache_len[:4] = torch.tensor([s, 200, 511, 513], dtype=torch.int32)
    n_pages = 1 + b * ns
    kp, vp = (torch.randn(n_pages, page, h, d, generator=g, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    perm = torch.randperm(b * ns, generator=g, device="cuda") + 1
    extent = (cache_len + page - 1) // page
    tab = torch.where(torch.arange(ns, device="cuda")[None, :]
                      < extent[:, None], perm.reshape(b, ns).to(torch.int32),
                      0)
    res, rows = {"cache_len": cache_len.tolist()}, {}
    exps = ("exact", "vexp", "vexp_hw")
    problems, checks = [], []
    worst = {"contig": 0.0, "paged": 0.0}

    def contig_fns(layout, qq, n):
        kl, vl = ((kc, vc) if layout == "bshd" else
                  (kc.transpose(1, 2).contiguous(),
                   vc.transpose(1, 2).contiguous()))
        ax, local = (1 if layout == "bshd" else 2), s // n
        sl = [(kl.narrow(ax, r * local, local), vl.narrow(ax, r * local,
                                                          local))
              for r in range(n)]
        offs = [r * local for r in range(n)]

        def kern(mode, pol, r):
            f = (da.decode_attention_partial if mode == "partial"
                 else da.decode_attention_partial_packed)
            return f(qq, *sl[r], cache_len, offs[r], layout=layout,
                     policy=pol)

        def plain(exp, r, blk):
            return da.decode_attention_partial_plain(
                qq, *sl[r], cache_len, offs[r], layout=layout, block_s=blk,
                exp_backend=exp)

        def textbook(exp, r):
            return textbook_partial(qq, *sl[r], cache_len, offs[r],
                                    layout=layout, exp=exp)

        def unsharded(pol):
            return da.decode_attention(qq, kl, vl, cache_len, layout=layout,
                                       policy=pol)
        return kern, plain, textbook, unsharded, offs, sl

    def paged_fns(layout, qq, n):
        kl, vl = ((kp, vp) if layout == "bshd" else
                  (kp.transpose(1, 2).contiguous(),
                   vp.transpose(1, 2).contiguous()))
        cols = ns // n
        shards = []
        for r in range(n):
            # shard r's own pool: its scratch page, then the pages its
            # table slice names; the slice rewritten to local ids
            t = tab[:, r * cols:(r + 1) * cols]
            ids = torch.unique(torch.cat([torch.zeros(1, dtype=t.dtype,
                                                      device="cuda"),
                                          t.reshape(-1)]))
            shards.append((kl[ids].contiguous(), vl[ids].contiguous(),
                           torch.searchsorted(ids, t).to(torch.int32)))
        offs = [r * cols * page for r in range(n)]

        def kern(mode, pol, r):
            f = (da.decode_attention_paged_partial if mode == "partial"
                 else da.decode_attention_paged_packed)
            return f(qq, *shards[r], cache_len, offs[r], layout=layout,
                     policy=pol)

        def plain(exp, r, blk):
            return da.decode_attention_paged_partial_plain(
                qq, *shards[r], cache_len, offs[r], layout=layout,
                exp_backend=exp, block=blk)

        def textbook(exp, r):
            kpool, vpool, t = shards[r]
            return textbook_partial(
                qq, da.paged_gather(kpool, t, layout),
                da.paged_gather(vpool, t, layout), cache_len, offs[r],
                layout=layout, exp=exp)

        def unsharded(pol):
            return da.decode_attention_paged(qq, kl, vl, tab, cache_len,
                                             layout=layout, policy=pol)
        return kern, plain, textbook, unsharded, offs, shards

    for kind, fns, kernel in (("contig", contig_fns,
                               "decode_attention_partial"),
                              ("paged", paged_fns,
                               "decode_attention_paged")):
        for layout in ("bshd", "bhsd"):
            for n in SHARD_COUNTS:
                kern, plain, textbook, unsharded, offs, _ = fns(layout, q,
                                                                n)
                block = (min(policy_cls().block_s, s // n)
                         if kind == "contig" else page)
                readings, fold = _sharded_case(
                    kernel, kern, plain, textbook, unsharded, q, cache_len,
                    offs, block, exps, policy_cls, problems)
                tag = f"{kind}_{layout}_n{n}_"
                for (exp, who), (err, share) in readings.items():
                    res[f"{tag}{exp}_{who}_max_abs_err"] = err
                    res[f"{tag}{exp}_{who}_mismatch_share"] = share
                res.update({f"{tag}{exp}_fold_max_abs_err": e
                            for exp, e in fold.items()})
                worst[kind] = max([worst[kind]] + [
                    err for (_, who), (err, _) in readings.items()
                    if who == "kernel"])
                checks.append((kernel, readings, f" {layout} n={n}"))
                # overflow guard: per-shard maxima hundreds apart
                q60 = (q.float() * 60.0).to(torch.bfloat16)
                kern60, _, _, uns60, _, _ = fns(layout, q60, n)
                for exp in exps:
                    pol = policy_cls(exp_backend=exp)
                    out = _fold_out([kern60("packed", pol, r)
                                     for r in range(n)], exp, q60)
                    if not bool(torch.isfinite(out).all()):
                        problems.append(f"{kernel} {layout} n={n} {exp}: "
                                        f"the fold overflowed at q x 60")
                    res[f"{tag}{exp}_q60_fold_max_abs_err"] = float(
                        (out.float() - uns60(pol).float()).abs().max())

    # times: n = 2, bshd, vexp, per shard; the row reports shard 0 (every
    # row has keys there: the most work)
    pol = policy_cls(exp_backend="vexp")
    qt = q.transpose(1, 2)
    q_bytes = b * h * d * 2
    for kind, fns in (("contig", contig_fns), ("paged", paged_fns)):
        kern, plain, _, _, offs, sl = fns("bshd", q, 2)
        local = s // 2
        for mode in ("partial", "packed"):
            name = {("contig", "partial"): "decode_attention_kernel_partial",
                    ("contig", "packed"): "decode_attention_kernel_packed",
                    ("paged", "partial"):
                        "decode_attention_kernel_paged_partial",
                    ("paged", "packed"):
                        "decode_attention_kernel_paged_packed"}[kind, mode]
            per = []
            for r, off in enumerate(offs):
                live_k = torch.clamp(cache_len - off, 0, local)
                if kind == "paged":      # whole live pages are read
                    live_rows = float(((live_k + page - 1) // page
                                       ).double().sum()) * page
                else:
                    live_rows = float(live_k.double().sum())
                nbytes = (live_rows * h * d * 2 * 2 + q_bytes
                          + b * h * (d + 2) * 4)
                flops = 4.0 * float(live_k.double().sum()) * h * d
                b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
                ms = cuda_time_ms(lambda: kern(mode, pol, r), iters=50)
                g_ms = graph_ms(lambda: kern(mode, pol, r),
                                f"{name} shard {r}", iters=50)
                blk = policy_cls().block_s if kind == "contig" else page

                def run_plain():
                    m, l, acc = plain("vexp", r, blk)
                    return ((m, l, acc) if mode == "partial"
                            else torch.cat([acc, m, l], dim=-1))
                plain_ms = cuda_time_ms(run_plain, iters=10)
                # SDPA over the shard's slice: the normalized output, not
                # the statistics (no library call returns them)
                if kind == "contig":
                    kk, vv = (t.transpose(1, 2) for t in sl[r])
                else:
                    kk, vv = (da.paged_gather(p, sl[r][2]).transpose(1, 2)
                              for p in sl[r][:2])
                mask = (torch.arange(kk.shape[2], device="cuda")[None, :]
                        < live_k[:, None])[:, None, None]
                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(
                        qt, kk, vv, attn_mask=mask)
                lib_ms = cuda_time_ms(sdpa, iters=50)
                lib_g_ms = graph_ms(sdpa, f"sdpa ({name} shard {r})",
                                    iters=50)
                per.append({"seq_offset": off, "ms": ms, "graph_ms": g_ms,
                            "plain_ms": plain_ms, "library_ms": lib_ms,
                            "library_graph_ms": lib_g_ms,
                            "bound_ms": b_ms, "bound_by": b_by,
                            "live_keys": int(live_k.sum())})
            res[f"{name}_by_shard"] = per
            res[f"{name}_stage_us_shard0"] = stage_device_us(
                lambda: kern(mode, pol, 0))
            src = ("src/repro_torch/csrc/decode_attention.cu"
                   if kind == "contig"
                   else "src/repro_torch/csrc/decode_attention_paged.cu")
            line = {"partial": 235, "packed": 280} if kind == "contig" \
                else {"partial": 490, "packed": 509}
            p0 = per[0]
            rows[name] = {
                "name": name, "route": "cuda", "source": src,
                "replaces": "src/repro/kernels/decode_attention/kernel.py:"
                            f"{line[mode]}",
                "launches": 0, "max_abs_err": worst[kind], "ms": p0["ms"],
                "graph_ms": p0["graph_ms"], "plain_ms": p0["plain_ms"],
                "bound_ms": p0["bound_ms"], "bound_by": p0["bound_by"],
                "library_ms": p0["library_ms"],
                "library_graph_ms": p0["library_graph_ms"],
                "library": "sdpa over the shard's slice (normalized output, "
                           "not the statistics)",
                "shape": "B=8 Hkv=12 G=1 d=64 S=1024 bshd, shard 0 of 2, "
                         "exp vexp"}
    emit({"phase": "sharded_decode", "shard_counts": list(SHARD_COUNTS),
          "fold_limit": FOLD_LIMIT, **res})
    if problems:
        fail(f"{problems[0]} ({len(problems) - 1} more failures)")
    for kernel, readings, where in checks:
        check_attention(kernel, readings, where)
    return [rows[k] for k in ("decode_attention_kernel_partial",
                              "decode_attention_kernel_packed",
                              "decode_attention_kernel_paged_partial",
                              "decode_attention_kernel_paged_packed")]


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) * q // 100, len(xs) - 1)]


def replay_logits(cfg, params, reqs, policy):
    """Teacher-forced logits of ``reqs`` (prompts + their emitted tokens)
    under ``policy``: one ragged prefill, then one decode step per
    emitted token. Returns a list of (B, V) f32 logits per step."""
    from repro_torch.models import transformer
    b = len(reqs)
    plen = np.array([len(r.prompt) for r in reqs], np.int32)
    toks = np.zeros((b, int(plen.max())), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :plen[i]] = r.prompt
    n = len(reqs[0].out)
    logits, pref = transformer.prefill(
        params, cfg, torch.as_tensor(toks, device="cuda"),
        prompt_len=torch.as_tensor(plen, device="cuda"), policy=policy)
    cache = transformer.init_cache(cfg, b, int(plen.max()) + n, "cuda")
    for name in ("k", "v"):
        cache[name][:, :, :toks.shape[1]] = pref[name]
    out = [logits[:, 0]]
    pos = torch.as_tensor(plen, device="cuda")
    for t in range(n - 1):
        tok = torch.as_tensor([[r.out[t]] for r in reqs], dtype=torch.int32,
                              device="cuda")
        logits, cache = transformer.decode_step(params, cfg, tok, cache,
                                                pos + t, policy=policy)
        out.append(logits[:, 0])
    return out


def replay_logits_paged(cfg, params, reqs, policy, hist_len, page):
    """Teacher-forced logits of ``reqs`` through the paged path, as a hot
    admission serves them: the shared ``hist_len``-token prefix (whole
    pages) prefilled once into pool pages that every row's table
    shares, each row's suffix prefilled against that history (attention
    at q_offset=hist_len), then one paged decode step per emitted
    token. Returns a list of (B, V) f32 logits per step."""
    from repro_torch.models import transformer
    from repro_torch.models.decode_state import (_paged_gather_hist,
                                                 _paged_scatter)
    b, n, lay = len(reqs), len(reqs[0].out), cfg.kv_cache_layout
    hp = hist_len // page
    slen = np.array([len(r.prompt) - hist_len for r in reqs], np.int32)
    sp = int(slen.max())
    ns = -(-(hist_len + sp + n) // page)
    tab = np.zeros((b, ns), np.int64)
    tab[:, :hp] = np.arange(1, hp + 1)               # the shared pages
    for i in range(b):
        first = 1 + hp + i * (ns - hp)
        tab[i, hp:] = np.arange(first, first + ns - hp)
    pool = transformer.init_paged_cache(cfg, 1 + hp + b * (ns - hp), page,
                                        "cuda")
    _, pre = transformer.prefill(
        params, cfg, torch.as_tensor(reqs[0].prompt[None, :hist_len],
                                     device="cuda"), policy=policy)
    for name in ("k", "v"):
        _paged_scatter(pool[name], pre[name], tab[:1, :hp], page, lay)
    hist = {name: _paged_gather_hist(pool[name], tab[:, :hp], page, lay)
            for name in ("k", "v")}
    toks = np.zeros((b, sp), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :slen[i]] = r.prompt[hist_len:]
    logits, suf = transformer.prefill(
        params, cfg, torch.as_tensor(toks, device="cuda"),
        prompt_len=torch.as_tensor(slen, device="cuda"), policy=policy,
        hist=hist)
    nc = -(-sp // page)
    for name in ("k", "v"):
        _paged_scatter(pool[name], suf[name], tab[:, hp:hp + nc], page, lay)
    tabs = torch.as_tensor(tab, dtype=torch.int32, device="cuda")
    out = [logits[:, 0]]
    pos = torch.as_tensor(slen + hist_len, device="cuda")
    for t in range(n - 1):
        tok = torch.as_tensor([[r.out[t]] for r in reqs], dtype=torch.int32,
                              device="cuda")
        logits, pool = transformer.decode_step_paged(
            params, cfg, tok, pool, tabs, pos + t, policy=policy)
        out.append(logits[:, 0])
    return out


# cuda tier vs reference tier, teacher-forced, full-width gpt2-small: the
# flash-decode kernels round q and p to bf16 where the reference tier's
# decode keeps f32 (the Pallas kernels do the same), and bf16
# activations carry that through 12 layers; logits are O(1).
REPLAY_LOGIT_TOL = 0.1


def check_replay(name, reqs, fast, ref):
    """cuda-tier logits within REPLAY_LOGIT_TOL of the reference tier's,
    finite, and every served token the reference argmax wherever the
    reference's top two logits are more than 2 x the limit apart."""
    d = max(float((a - b).abs().max()) for a, b in zip(fast, ref))
    if not all(bool(torch.isfinite(a).all()) for a in fast):
        fail(f"replay {name}: non-finite logits")
    if d > REPLAY_LOGIT_TOL:
        fail(f"replay {name}: cuda vs reference tier logits differ by {d} "
             f"(limit {REPLAY_LOGIT_TOL})")
    for i, r in enumerate(reqs):
        for t, lg in enumerate(ref):
            top = torch.topk(lg[i], 2).values
            if float(top[0] - top[1]) > 2 * REPLAY_LOGIT_TOL and \
                    int(lg[i].argmax()) != r.out[t]:
                fail(f"replay {name}: request {r.rid} step {t} token "
                     f"{r.out[t]} != reference argmax {int(lg[i].argmax())}")
    return d


class SmiSampler:
    """nvidia-smi's SM clock, memory clock and power draw, sampled every
    200 ms while the ``with`` block runs; the sampler process is stopped
    on exit."""

    FIELDS = ("clocks_sm_mhz", "clocks_mem_mhz", "power_draw_w")

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.samples = []
        for line in out.splitlines():
            try:
                self.samples.append([float(x) for x in line.split(",")])
            except ValueError:         # "[N/A]" fields
                continue
        return False

    def summary(self):
        rows = [s for s in self.samples if len(s) == len(self.FIELDS)]
        if not rows:
            return "not measured"
        out = {"samples": len(rows)}
        for name, col in zip(self.FIELDS, zip(*rows)):
            col = sorted(col)
            out[name] = {"min": col[0], "median": col[len(col) // 2],
                         "max": col[-1]}
        return out


def timed_serve(kernels, srv, reqs):
    """Serve ``reqs`` with every launch count set to 0 just before and read
    just after, SDPA calls counted, peak device memory and clocks / power
    sampled. Returns (seconds, launch counts, SDPA calls, peak bytes,
    nvidia-smi summary)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_calls = []

    def counting_sdpa(*a, **k):
        sdpa_calls.append(1)
        return sdpa(*a, **k)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.nn.functional.scaled_dot_product_attention = counting_sdpa
    kernels.reset_launch_counts()
    try:
        with SmiSampler() as smi:
            t0 = time.perf_counter()
            srv.run(reqs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        torch.nn.functional.scaled_dot_product_attention = sdpa
    counts = kernels.launch_counts()
    return (secs, counts, len(sdpa_calls), torch.cuda.max_memory_allocated(),
            smi.summary())


def check_requests(cfg, reqs, max_new):
    for r in reqs:
        out = np.asarray(r.out)
        if (r.finish_reason != "max_new" or len(out) != max_new
                or (out < 0).any() or (out >= cfg.vocab).any()):
            fail(f"request {r.rid}: {r.finish_reason}, {len(out)} tokens, "
                 f"range [{out.min()}, {out.max()}]")


def serve_metrics(reqs, secs):
    ntok = sum(len(r.out) for r in reqs)
    ttft = [r.t_first - r.t_submit for r in reqs]
    lat = [r.t_done - r.t_submit for r in reqs]
    return {"requests": len(reqs), "tokens": ntok, "seconds": secs,
            "tok_s": ntok / secs, "ttft_p50_s": _pct(ttft, 50),
            "ttft_p95_s": _pct(ttft, 95), "req_p50_s": _pct(lat, 50),
            "req_p95_s": _pct(lat, 95)}


def near_tie_compare(cfg, params, groups, reqs, others, what, against):
    """Each request's tokens against ``others`` (the same request served
    another way): equal, or diverging first at a step where the reference
    tier's top-2 logit gap is a near tie (<= 2 x REPLAY_LOGIT_TOL).
    Returns the counts; fails on a divergence that is not a near tie."""
    from repro_torch.models import transformer
    near_ties, same = [], 0
    for r, other in zip(reqs, others):
        diff = [i for i, (a, b) in enumerate(zip(r.out, other)) if a != b]
        if not diff and len(r.out) == len(other):
            same += 1
            continue
        i = diff[0] if diff else min(len(r.out), len(other))
        seq = np.concatenate([r.prompt, np.asarray(other[:i], np.int32)])
        lg, _ = transformer.prefill(
            params, cfg, torch.as_tensor(seq[None], device="cuda"),
            policy=groups[r.group].replace(kernel_backend="reference"))
        top = torch.topk(lg[0, 0], 2).values
        gap = float(top[0] - top[1])
        if gap > 2 * REPLAY_LOGIT_TOL:
            fail(f"{what} {r.rid} ({r.group}) leaves {against} at step {i} "
                 f"where the reference's top-2 gap is {gap}, not a near "
                 f"tie")
        near_ties.append({"rid": r.rid, "step": i, "top2_gap": gap})
    return {"identical": same, "near_tie_divergences": near_ties}


def gpt2_small_setup():
    """Full-width gpt2-small with random weights from seed 0, its default
    policy (which must be the cuda tier) and the three policy groups."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.runtime import parse_policy_groups, resolve_policy
    cfg = get_config("gpt2-small")
    params = api.init_params(cfg, 0, device="cuda")
    policy = resolve_policy(cfg, env={})
    if policy.kernel_backend != "cuda":
        fail(f"default tier is {policy.kernel_backend}, not cuda")
    groups = parse_policy_groups("eval=exact,bulk=vexp,hw=vexp_hw", cfg,
                                 base=policy)
    return cfg, params, policy, groups


ARMS = ("graph", "eager")
ARM_TURNS = 2          # graph, eager, graph, eager: the host spreads by 1.7x


def check_serve_counts(cfg, st, counts, sdpa_calls, decode, other, what):
    """A serve's launches: ``decode`` = layers x decode steps, FA =
    layers x (admission waves + prefill chunks), none of the ``other``
    decode kernel, no SDPA call. Returns (waves, chunks, steps)."""
    waves = sum(s["admit_waves"] for s in st.values())
    chunks = sum(s["prefill_chunks"] for s in st.values())
    steps = sum(s["decode_steps"] for s in st.values())
    if counts["flash_attention"] != cfg.n_layers * (waves + chunks):
        fail(f"{what}: flash_attention launches {counts['flash_attention']} "
             f"!= {cfg.n_layers} layers x ({waves} admission waves + "
             f"{chunks} prefill chunks)")
    if counts[decode] != cfg.n_layers * steps:
        fail(f"{what}: {decode} launches {counts[decode]} != "
             f"{cfg.n_layers} layers x {steps} decode steps")
    if counts[other]:
        fail(f"{what}: launched {other} {counts[other]} times")
    if sdpa_calls:
        fail(f"{what}: {sdpa_calls} library attention calls on the port's "
             f"path")
    return waves, chunks, steps


def check_graph_stats(cfg, st, arm, replayed, decode, what):
    """Graph arm: one decode capture per group, made when the Server was
    built (before the serve's counts were reset), and every decode step
    a replay (replays = decode steps), and the decode kernel's replayed
    launches = layers x replays; a chunked group also one chunk-program
    capture, every chunk a replay, and FA's replayed launches = layers x
    chunk replays. Eager arm: no capture, no replay. Returns {group:
    (captures, replays, chunk captures, chunk replays)}."""
    out = {}
    for n, s in st.items():
        cap, rep = s["graph_captures"], s["graph_replays"]
        ccap, crep = s["chunk_graph_captures"], s["chunk_graph_replays"]
        if arm == "graph":
            if s["step_mode"] != "graph" or cap != 1 or \
                    rep != s["decode_steps"]:
                fail(f"{what} group {n}: {s['step_mode']}, {cap} captures, "
                     f"{rep} replays in {s['decode_steps']} decode steps "
                     f"(want one capture, then a replay a step)")
            if ccap != (1 if s["prefill_chunk"] else 0) or \
                    crep != s["prefill_chunks"]:
                fail(f"{what} group {n}: {ccap} chunk captures, {crep} "
                     f"replays in {s['prefill_chunks']} chunks")
        elif cap or rep or ccap or crep:
            fail(f"{what} group {n} ({arm}): {cap} / {ccap} captures, "
                 f"{rep} / {crep} replays")
        out[n] = (cap, rep, ccap, crep)
    replays = sum(v[1] for v in out.values())
    if replayed[decode] != cfg.n_layers * replays:
        fail(f"{what}: {replayed[decode]} replayed {decode} launches != "
             f"{cfg.n_layers} layers x {replays} replays")
    chunk_replays = sum(v[3] for v in out.values())
    if replayed["flash_attention"] != cfg.n_layers * chunk_replays:
        fail(f"{what}: {replayed['flash_attention']} replayed "
             f"flash_attention launches != {cfg.n_layers} layers x "
             f"{chunk_replays} chunk replays")
    return out


def serve_in_turns(kernels, cfg, make_server, make_reqs, decode, other,
                   what, after=None):
    """Serve ``make_reqs()`` through ``make_server(cuda_graphs)`` with
    graphs and eagerly, in turns (graph, eager, graph, eager), every
    serve with its launch counts set to 0 just before and read just
    after and checked; ``after(srv, stats)`` runs on each drained
    server. Returns {arm: [turn, ...]}, each turn a dict with the
    requests, stats, counts and readings."""
    runs = {arm: [] for arm in ARMS}
    for _ in range(ARM_TURNS):
        for arm in ARMS:
            srv = make_server(arm == "graph")
            reqs = make_reqs()
            secs, counts, sdpa_calls, peak, clocks = timed_serve(kernels,
                                                                 srv, reqs)
            replayed = kernels.replay_counts()
            st = srv.stats()
            where = f"{what} ({arm} arm)"
            waves, chunks, steps = check_serve_counts(
                cfg, st, counts, sdpa_calls, decode, other, where)
            graphs = check_graph_stats(cfg, st, arm, replayed, decode, where)
            if after is not None:
                after(srv, st)
            some = next(iter(st.values()))
            runs[arm].append({
                "reqs": reqs, "stats": st, "counts": counts,
                "readings": {
                    **serve_metrics(reqs, secs),
                    "wall_per_decode_step_s": some["wall_per_decode_step_s"],
                    "p50_host_dispatch_s": {
                        n: s["p50_host_dispatch_s"] for n, s in st.items()
                        if s["decode_steps"]},
                    "admit_s_total": sum(s["admit_s_total"]
                                         for s in st.values()),
                    "graph_capture_s": sum(s["graph_capture_s"]
                                           for s in st.values()),
                    "admit_waves": waves, "decode_steps": steps,
                    "prefill_chunks": chunks,
                    "chunk_dispatch_s_total": sum(s["chunk_s_total"]
                                                  for s in st.values()),
                    "p50_chunk_dispatch_s": {
                        n: s["p50_chunk_dispatch_s"] for n, s in st.items()
                        if s["prefill_chunks"]},
                    "decode_steps_prefilling": sum(
                        s["decode_steps_prefilling"] for s in st.values()),
                    "graph_captures": sum(v[0] for v in graphs.values()),
                    "graph_replays": sum(v[1] for v in graphs.values()),
                    "chunk_graph_captures": sum(v[2]
                                                for v in graphs.values()),
                    "chunk_graph_replays": sum(v[3]
                                               for v in graphs.values()),
                    "chunk_graph_capture_s": sum(s["chunk_graph_capture_s"]
                                                 for s in st.values()),
                    "replayed_launches": replayed[decode],
                    "replayed_flash_attention": replayed["flash_attention"],
                    "peak_memory_bytes": peak, "clocks_power": clocks}})
    return runs


def compare_arms(runs, what):
    """Each turn's graph-arm tokens against the same turn's eager arm:
    the same kernels on the same inputs, so every token must be equal.
    Returns the count of identical requests per turn."""
    same = []
    for t, (g, e) in enumerate(zip(runs["graph"], runs["eager"])):
        for r, o in zip(g["reqs"], e["reqs"]):
            if list(r.out) != list(o.out):
                i = next((i for i, (a, b) in enumerate(zip(r.out, o.out))
                          if a != b), min(len(r.out), len(o.out)))
                fail(f"{what} turn {t}: graph-arm request {r.rid} "
                     f"({r.group}) leaves its eager-arm tokens at step {i}")
        same.append({"identical": len(g["reqs"])})
    return same


def capture_audits(cfg, make_server, make_reqs, what):
    """A graph-arm server stepped past each group's capture: every group
    with live slots passes ``graph_audit.capture_audit`` (replay ==
    eager step from the same carry), and the serve then drains as it
    would have. Returns {group: audit}."""
    from repro_torch.analysis import graph_audit
    srv = make_server(True)
    reqs = make_reqs()
    for r in reqs:
        srv.submit(r)
    for _ in range(3):               # admission, then replays
        srv.step()
    audits = {}
    for name, g in srv._groups.items():
        if not g.busy:
            continue
        try:
            audits[name] = graph_audit.capture_audit(g.state, g.last,
                                                     g.live_dev)
        except graph_audit.AuditError as e:
            fail(f"{what} capture audit, group {name}: {e}")
    if len(audits) != len({r.group for r in reqs}):
        fail(f"{what} capture audit: groups audited {sorted(audits)}")
    srv.drain()
    check_requests(cfg, reqs, reqs[0].max_new)
    return audits


def arm_summary(runs, profiles, audits, compare, what):
    """The per-arm readings of one serve path, one JSON line."""
    emit({"phase": f"{what}_arms", "turns": ARM_TURNS,
          "arms": {arm: {"turns": [t["readings"] for t in runs[arm]],
                         "profile": profiles[arm]} for arm in ARMS},
          "capture_audit": audits, "graph_vs_eager_tokens": compare})


def phase_serve(kernels, smi, cfg, params, policy, groups):
    """Full-width gpt2-small through the port's Server: max_batch 8,
    max_seq 1024, 16 requests with prompt lengths in [32, 512], 64 new
    tokens each, policy groups eval=exact, bulk=vexp, hw=vexp_hw; served
    with each group's decode step as one CUDA graph and eagerly, in
    turns. Returns ({path: launch counts} of the first turn of each
    arm, the first graph turn's requests)."""
    from repro_torch.launch.serve import Server, make_requests

    def server(cuda_graphs=True):
        return Server(cfg, params, max_batch=8, max_seq=1024, policy=policy,
                      policy_groups=groups, device="cuda",
                      cuda_graphs=cuda_graphs)

    def requests():
        return make_requests(cfg, 16, 512, 64, mixed_lengths=True,
                             min_len=32, groups=sorted(groups), seed=0)

    # warm-up (cuBLAS handles, library loads), not measured
    for arm in ARMS:
        server(arm == "graph").run(make_requests(
            cfg, 3, 64, 4, groups=sorted(groups), seed=1))
    torch.cuda.synchronize()

    runs = serve_in_turns(kernels, cfg, server, requests,
                          "decode_attention", "decode_attention_paged",
                          "serve")
    first = runs["graph"][0]
    reqs, counts = first["reqs"], first["counts"]
    for arm in ARMS:
        for t in runs[arm]:
            check_requests(cfg, t["reqs"], 64)
    compare = compare_arms(runs, "serve")
    res = {"phase": "serve", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab_padded": cfg.vocab_padded,
           "arm": "graph", **first["readings"], "launches": counts,
           "prompt_lens": [len(r.prompt) for r in reqs], "nvidia_smi": smi}

    # teacher-forced replay of 2 requests per group: cuda vs reference tier
    worst = {}
    for name, pol in groups.items():
        two = [r for r in reqs if r.group == name][:2]
        fast = replay_logits(cfg, params, two, pol)
        ref = replay_logits(cfg, params, two,
                            pol.replace(kernel_backend="reference"))
        worst[name] = check_replay(name, two, fast, ref)
    res["replay_max_abs_logit_diff"] = worst

    def short():
        return make_requests(cfg, 8, 512, 16, mixed_lengths=True,
                             min_len=32, groups=sorted(groups), seed=2)

    profiles = {arm: profile_serve(kernels, lambda a=arm: server(a == "graph"),
                                   short(), f"serve ({arm} arm)")
                for arm in ARMS}
    res["profile"] = profiles["graph"]
    audits = capture_audits(cfg, server, lambda: make_requests(
        cfg, 6, 64, 8, groups=sorted(groups), seed=3), "serve")
    emit(res)
    arm_summary(runs, profiles, audits, compare, "serve")
    return {"serve": counts, "serve_eager": runs["eager"][0]["counts"]}, reqs


def phase_serve_paged(kernels, smi, cfg, params, policy, groups):
    """Full-width gpt2-small through Server(paged=True): max_batch 8,
    max_seq 1024, page 64, 32 requests on one shared 256-token prefix
    plus a suffix of [32, 256] tokens (seed 0), 64 new tokens each, the
    same three policy groups, with graphs and eagerly in turns. Each
    group's first wave is cold and publishes the prefix; its later waves
    attach it and prefill only the suffixes (FA at q_offset=256).
    Returns ({path: launch counts}, the first graph turn's requests)."""
    from repro_torch.launch.serve import Request, Server, make_requests
    shared, suffix, max_new = 256, 256, 64     # as in paged_requests
    policy = policy.replace(block_page=PAGE)
    groups = {n: p.replace(block_page=PAGE) for n, p in groups.items()}

    def server(cuda_graphs=True, pol=policy, grp=groups):
        return Server(cfg, params, max_batch=8, max_seq=1024, policy=pol,
                      policy_groups=grp, device="cuda", paged=True,
                      cuda_graphs=cuda_graphs)

    def hot_and_clean(srv, st):
        for name in groups:         # the server's idle "default" group aside
            s, pool = st[name], st[name]["pool"]
            if (s["admit_waves"] < 2 or s["hot_waves"] < 1
                    or pool["prefix"]["hits"] <= 0):
                fail(f"paged group {name}: {s['admit_waves']} waves, "
                     f"{s['hot_waves']} hot, {pool['prefix']['hits']} "
                     f"prefix hits; every group needs a hot wave")
        srv.assert_idle_clean()     # drops the prefix cache: stats first

    runs = serve_in_turns(kernels, cfg, server,
                          lambda: paged_requests(cfg, groups),
                          "decode_attention_paged", "decode_attention",
                          "serve_paged", after=hot_and_clean)
    first = runs["graph"][0]
    reqs, st, counts = first["reqs"], first["stats"], first["counts"]
    for arm in ARMS:
        for t in runs[arm]:
            check_requests(cfg, t["reqs"], max_new)
    pools = {name: st[name]["pool"] for name in groups}
    hot_reqs = [r for r in reqs if r.prefix_hit]
    compare = compare_arms(runs, "serve_paged")

    hit_tokens = sum(p["prefix"]["hit_tokens"] for p in pools.values())
    res = {"phase": "serve_paged", "arch": cfg.arch_id, "page": PAGE,
           "shared_prefix": shared, "arm": "graph", **first["readings"],
           "launches": counts, "hot_requests": len(hot_reqs),
           # admission wall (synced), per group: all waves and hot waves
           "admit_s": {n: {"waves": st[n]["admit_waves"],
                           "total": st[n]["admit_s_total"],
                           "hot_waves": st[n]["hot_waves"],
                           "hot_total": st[n]["hot_admit_s_total"]}
                       for n in groups},
           # prompt tokens served from the prefix cache, over all prompt
           # tokens; the cache's own hit_rate counts hot waves' lookups
           "prefix_hit_token_share": hit_tokens / sum(len(r.prompt)
                                                      for r in reqs),
           "prefix_hit_rate": {n: p["prefix"]["hit_rate"]
                               for n, p in pools.items()},
           "peak_pages": {n: p["peak_pages"] for n, p in pools.items()},
           "pages_allocatable": pools[sorted(pools)[0]]["pages_allocatable"],
           "peak_oversubscription": {n: p["peak_oversubscription"]
                                     for n, p in pools.items()},
           "pool": pools, "prompt_lens": [len(r.prompt) for r in reqs],
           "nvidia_smi": smi}

    # teacher-forced replay through the hot path, 2 hot requests per
    # group: cuda vs reference tier
    worst = {}
    for name, pol in groups.items():
        two = [r for r in hot_reqs if r.group == name][:2]
        fast = replay_logits_paged(cfg, params, two, pol, shared, PAGE)
        ref = replay_logits_paged(cfg, params, two,
                                  pol.replace(kernel_backend="reference"),
                                  shared, PAGE)
        worst[name] = check_replay(f"paged {name}", two, fast, ref)
    res["replay_max_abs_logit_diff"] = worst

    # every hot request against the same request served cold and alone
    solos = []
    for r in hot_reqs:
        solo = Request(r.rid, r.prompt.copy(), max_new)
        server(True, groups[r.group], None).run([solo])
        solos.append(solo.out)
    res["hot_equals_cold_solo"] = near_tie_compare(
        cfg, params, groups, hot_reqs, solos, "hot request",
        "its cold solo tokens")

    def short():
        return make_requests(cfg, 8, suffix, 16, mixed_lengths=True,
                             min_len=32, groups=sorted(groups), seed=2,
                             shared_prefix=shared)

    profiles = {arm: profile_serve(kernels, lambda a=arm: server(a == "graph"),
                                   short(), f"serve_paged ({arm} arm)")
                for arm in ARMS}
    res["profile"] = profiles["graph"]
    audits = capture_audits(cfg, server, lambda: make_requests(
        cfg, 6, 64, 8, groups=sorted(groups), seed=3, shared_prefix=PAGE),
        "serve_paged")
    emit(res)
    arm_summary(runs, profiles, audits, compare, "serve_paged")
    return ({"serve_paged": counts,
             "serve_paged_eager": runs["eager"][0]["counts"]}, reqs)


def chunked_groups(policy, groups, chunk, page=None):
    """The policy and groups with ``prefill_chunk=chunk`` (and pages of
    ``page`` tokens where given)."""
    kw = {"prefill_chunk": chunk}
    if page is not None:
        kw["block_page"] = page
    return policy.replace(**kw), {n: p.replace(**kw)
                                  for n, p in groups.items()}


def check_overlap(runs, what):
    """Every turn ran decode steps while a prompt was still streaming in
    (the point of chunking); returns the counts per arm and turn."""
    out = {}
    for arm in ARMS:
        out[arm] = [t["readings"]["decode_steps_prefilling"]
                    for t in runs[arm]]
        if min(out[arm]) < 1:
            fail(f"{what} ({arm} arm): no decode step ran while a prompt "
                 f"was prefilling ({out[arm]})")
    return out


def phase_serve_chunked(kernels, smi, cfg, params, policy, groups, mono):
    """The contiguous serve's requests with ``prefill_chunk=128``: each
    prompt streams into its slot one 128-token chunk a tick, one chunk
    program per group (one FA launch per layer over the 1,024-row cache
    with a (B,) q_offset tensor) between decode steps; graph and eager
    arms in turns. Tokens against the monolithic serve's (``mono``, its
    first graph turn) up to a near tie. Returns {path: launch counts}."""
    from repro_torch.launch.serve import Server, make_requests
    pol, grp = chunked_groups(policy, groups, 128)

    def server(cuda_graphs=True):
        return Server(cfg, params, max_batch=8, max_seq=1024, policy=pol,
                      policy_groups=grp, device="cuda",
                      cuda_graphs=cuda_graphs)

    def requests():
        return make_requests(cfg, 16, 512, 64, mixed_lengths=True,
                             min_len=32, groups=sorted(groups), seed=0)

    for arm in ARMS:                  # warm-up, not measured
        server(arm == "graph").run(make_requests(
            cfg, 3, 200, 4, groups=sorted(groups), seed=1))
    torch.cuda.synchronize()
    runs = serve_in_turns(kernels, cfg, server, requests,
                          "decode_attention", "decode_attention_paged",
                          "serve_chunked")
    for arm in ARMS:
        for t in runs[arm]:
            check_requests(cfg, t["reqs"], 64)
    first = runs["graph"][0]
    res = {"phase": "serve_chunked", "prefill_chunk": 128, "arm": "graph",
           **first["readings"], "launches": first["counts"],
           "overlap_decode_steps": check_overlap(runs, "serve_chunked"),
           "graph_vs_eager_tokens": compare_arms(runs, "serve_chunked"),
           "chunked_equals_monolithic": near_tie_compare(
               cfg, params, grp, first["reqs"], [m.out for m in mono],
               "chunked request", "its monolithic tokens"),
           "nvidia_smi": smi}
    emit(res)
    arm_summary(runs, {arm: None for arm in ARMS}, None,
                res["graph_vs_eager_tokens"], "serve_chunked")
    return {"serve_chunked": first["counts"],
            "serve_chunked_eager": runs["eager"][0]["counts"]}


def phase_serve_paged_chunked(kernels, smi, cfg, params, policy, groups,
                              mono):
    """The paged serve's requests with ``prefill_chunk=96`` on 64-token
    pages, so chunks straddle pages: each request reserves its table and
    attaches its own prefix-cache hits when admitted, its cursor past
    them; graph and eager arms in turns. Tokens against the monolithic
    paged serve's (``mono``) up to a near tie; every group attaches
    prefix pages to some request; each hot request against the same
    request served cold and alone; ``assert_idle_clean()``."""
    from repro_torch.launch.serve import Request, Server
    pol, grp = chunked_groups(policy, groups, 96, PAGE)

    def server(cuda_graphs=True, p=pol, g=grp):
        return Server(cfg, params, max_batch=8, max_seq=1024, policy=p,
                      policy_groups=g, device="cuda", paged=True,
                      cuda_graphs=cuda_graphs)

    def hot_and_clean(srv, st):
        for name in groups:
            if st[name]["pool"]["prefix"]["hits"] <= 0:
                fail(f"paged chunked group {name}: no prefix hit")
        srv.assert_idle_clean()

    runs = serve_in_turns(kernels, cfg, server,
                          lambda: paged_requests(cfg, groups),
                          "decode_attention_paged", "decode_attention",
                          "serve_paged_chunked", after=hot_and_clean)
    for arm in ARMS:
        for t in runs[arm]:
            check_requests(cfg, t["reqs"], 64)
            for name in groups:
                if not any(r.prefix_hit for r in t["reqs"]
                           if r.group == name):
                    fail(f"paged chunked ({arm}) group {name}: no request "
                         f"attached prefix pages")
    first = runs["graph"][0]
    reqs = first["reqs"]
    hot = [r for r in reqs if r.prefix_hit]
    solos = []
    for r in hot:
        solo = Request(r.rid, r.prompt.copy(), r.max_new)
        server(True, grp[r.group], None).run([solo])
        solos.append(solo.out)
    res = {"phase": "serve_paged_chunked", "prefill_chunk": 96,
           "page": PAGE, "arm": "graph", **first["readings"],
           "launches": first["counts"],
           "prefix_hit_tokens_per_request": [r.prefix_hit for r in reqs],
           "pool": {n: first["stats"][n]["pool"] for n in groups},
           "overlap_decode_steps": check_overlap(runs, "serve_paged_chunked"),
           "graph_vs_eager_tokens": compare_arms(runs,
                                                 "serve_paged_chunked"),
           "chunked_equals_monolithic": near_tie_compare(
               cfg, params, grp, reqs, [m.out for m in mono],
               "paged chunked request", "its monolithic tokens"),
           "hot_equals_cold_solo": near_tie_compare(
               cfg, params, grp, hot, solos, "hot chunked request",
               "its cold solo tokens"),
           "nvidia_smi": smi}
    emit(res)
    arm_summary(runs, {arm: None for arm in ARMS}, None,
                res["graph_vs_eager_tokens"], "serve_paged_chunked")
    return {"serve_paged_chunked": first["counts"],
            "serve_paged_chunked_eager": runs["eager"][0]["counts"]}


# ------------------------------------------------ self-speculative decode

SPEC_VERIFIES = ("scan", "chunk")


def spec_policy_groups(groups, verify, page=None):
    """The policy groups speculating: spec_k = SPEC_K, drafts under
    vexp_hw (the hw group drafts under its own backend), ``verify`` the
    verify impl; pages of ``page`` tokens where given. The server's base
    policy stays plain, so its idle "default" group does not speculate."""
    kw = dict(spec_k=SPEC_K, draft_exp_backend="vexp_hw",
              spec_verify=verify)
    if page is not None:
        kw["block_page"] = page
    return {n: p.replace(**kw) for n, p in groups.items()}


def check_spec_serve(cfg, st, before, counts, replayed, sdpa_calls, decode,
                     other, verify, arm, what):
    """A speculating serve's launches and graphs. Per group, bursts =
    decode steps; decode launches = 12 x (2k + 1) a scan burst and 12 x k
    a chunk burst, FA = 12 x (waves + chunks + chunk bursts), none of the
    ``other`` decode kernel, no SDPA call. Graph arm: every burst k
    draft replays and one verify replay, replayed launches = all decode
    launches (and the chunk bursts' FA launches), and the captures
    those the group made when it was built (``before``): none during
    the serve. Returns the bursts per group."""
    k, n = SPEC_K, cfg.n_layers
    bursts = {g: s["decode_steps"] for g, s in st.items() if "spec_k" in s}
    total = sum(bursts.values())
    plain = sum(s["decode_steps"] for g, s in st.items() if g not in bursts)
    waves = sum(s["admit_waves"] for s in st.values())
    chunks = sum(s["prefill_chunks"] for s in st.values())
    per_burst = 2 * k + 1 if verify == "scan" else k
    want_fa = n * (waves + chunks + (total if verify == "chunk" else 0))
    if plain or counts[decode] != n * per_burst * total:
        fail(f"{what}: {decode} launches {counts[decode]} != {n} layers x "
             f"{per_burst} x {total} bursts ({plain} plain steps)")
    if counts["flash_attention"] != want_fa:
        fail(f"{what}: flash_attention launches "
             f"{counts['flash_attention']} != {want_fa}")
    if counts[other] or sdpa_calls:
        fail(f"{what}: {counts[other]} {other} launches, {sdpa_calls} SDPA "
             f"calls")
    for g, s in st.items():
        if g not in bursts:
            continue
        caps = (s["graph_captures"], s["spec_graph_captures"])
        if arm == "eager":
            if any(caps) or s["graph_replays"] or s["spec_graph_replays"]:
                fail(f"{what} group {g} (eager): captures {caps}")
            continue
        if caps != (before[g]["graph_captures"],
                    before[g]["spec_graph_captures"]) or caps[1] != 1:
            fail(f"{what} group {g}: captures {caps} after the serve, "
                 f"{before[g]['graph_captures']} / "
                 f"{before[g]['spec_graph_captures']} when built")
        if s["spec_graph_replays"] != bursts[g] or \
                s["graph_replays"] != k * bursts[g]:
            fail(f"{what} group {g}: {s['graph_replays']} draft and "
                 f"{s['spec_graph_replays']} verify replays in {bursts[g]} "
                 f"bursts")
    if arm == "graph":
        fa_rep = n * total if verify == "chunk" else 0
        if replayed[decode] != counts[decode] or \
                replayed["flash_attention"] != fa_rep:
            fail(f"{what}: replayed {replayed[decode]} {decode} / "
                 f"{replayed['flash_attention']} FA launches of "
                 f"{counts[decode]} / {fa_rep}")
    return bursts


def check_own_draft_control(cfg, st, reqs, group, verify, what):
    """The hw group drafts under its own backend: with the scan verify
    every draft lane agrees, so a request of max_new tokens and no cap
    clamp takes ceil((max_new - 1) / W) bursts and accepts all but the
    last burst's clamped lanes. Returns the group's counts."""
    s = st[group]
    rs = [r for r in reqs if r.group == group]
    w = SPEC_K + 1
    want_b = sum(-(-(len(r.out) - 1) // w) for r in rs)
    want_acc = sum(len(r.out) - 1 for r in rs) - want_b
    got = {"bursts": s["spec_bursts"], "accepted": s["spec_accepted"],
           "want_bursts": want_b, "want_accepted": want_acc}
    if verify == "scan" and (s["spec_bursts"], s["spec_accepted"]) != \
            (want_b, want_acc):
        fail(f"{what}: the {group} group's drafts under its own backend "
             f"disagree with its scan verify: {got}")
    return got


def spec_readings(reqs, st, secs, peak, clocks):
    """Per group: tok/s over the group's own wall (first submit to last
    token), bursts, tokens per burst, drafted / accepted / rolled back
    and the acceptance share, capture s; and the serve's tok/s, wall per
    burst and peak memory."""
    out = {"tok_s": sum(len(r.out) for r in reqs) / secs, "seconds": secs,
           "wall_per_burst_s": next(iter(st.values()))[
               "wall_per_decode_step_s"],
           "peak_memory_bytes": peak, "clocks_power": clocks, "groups": {}}
    for g, s in st.items():
        rs = [r for r in reqs if r.group == g]
        if not rs:
            continue
        wall = max(r.t_done for r in rs) - min(r.t_submit for r in rs)
        ntok = sum(len(r.out) for r in rs)
        row = {"tokens": ntok, "tok_s": ntok / wall, "wall_s": wall,
               "capture_s": s["graph_capture_s"]
               + s.get("spec_graph_capture_s", 0.0)}
        if "spec_k" in s:
            b = max(s["spec_bursts"], 1)
            row.update({k: s[k] for k in (
                "spec_bursts", "spec_drafted", "spec_accepted",
                "spec_rolled_back", "spec_acceptance")})
            row["tokens_per_burst"] = (ntok - len(rs)) / b
        out["groups"][g] = row
    return out


def spec_graph_ms(make_server, reqs, group):
    """Graph ms of one draft step, one verify and one plain decode step
    of ``group``'s state, each its captured graph replayed back to back
    between CUDA events, on a live pool (the first wave admitted, one
    burst run); replays advance positions by at most 23 rows."""
    srv = make_server()
    for r in reqs:
        srv.submit(r)
    srv.step()
    srv.step()
    st = srv._groups[group].state
    out = {"draft_step": cuda_time_ms(st._draft_graph.graph.replay),
           "verify": cuda_time_ms(st._verify["graph"].graph.replay),
           "plain_step": cuda_time_ms(st.graph.graph.replay),
           "live_slots": int(srv._groups[group].live_dev.sum())}
    torch.cuda.synchronize()
    return out


def phase_serve_spec(kernels, smi, cfg, params, policy, groups, mono):
    """Self-speculative decode on the contiguous serve's 16 requests
    (prompts in [32, 512], 64 new tokens, the three groups, max_batch 8,
    max_seq 1,024): each group at spec_k = 4, drafts under vexp_hw,
    verify "scan" and "chunk", in turns with a plain graph serve of the
    same requests (plain, scan, chunk, twice), then the scan serve once
    eagerly. Scan tokens equal the plain serve's (``mono``, the first
    monolithic graph turn, and this phase's own plain turns) request by
    request; chunk tokens up to a near tie; the hw group's drafts agree
    with its scan verify on every unclamped lane; a sharded group asked
    to speculate raises. Returns {path: launch counts}."""
    from repro_torch.launch.serve import Server, make_requests

    class _OneRankOfTwo:             # rank 0 of a two-rank ShardGroup
        world, rank, calls = 2, 0, 0

    try:
        Server(cfg, params, max_batch=8, max_seq=1024, policy=policy,
               policy_groups=spec_policy_groups(groups, "scan"),
               device="cuda", kv_mode="seq", shards=_OneRankOfTwo())
        fail("a sequence-sharded group accepted speculative decode")
    except ValueError as e:
        sharded_refusal = str(e)

    def server(verify, cuda_graphs=True):
        grp = groups if verify is None else spec_policy_groups(groups,
                                                               verify)
        return Server(cfg, params, max_batch=8, max_seq=1024, policy=policy,
                      policy_groups=grp, device="cuda",
                      cuda_graphs=cuda_graphs)

    def requests():
        return make_requests(cfg, 16, 512, 64, mixed_lengths=True,
                             min_len=32, groups=sorted(groups), seed=0)

    for verify in SPEC_VERIFIES:                 # warm-up, not measured
        server(verify).run(make_requests(cfg, 3, 64, 8,
                                         groups=sorted(groups), seed=1))
    torch.cuda.synchronize()
    runs = {mode: [] for mode in ("plain", *SPEC_VERIFIES)}
    counts_by_path = {}
    arms = [(m, "graph") for _ in range(ARM_TURNS)
            for m in ("plain", *SPEC_VERIFIES)] + [("scan", "eager")]
    for mode, arm in arms:
        verify = None if mode == "plain" else mode
        srv = server(verify, arm == "graph")
        before = srv.stats()
        reqs = requests()
        secs, counts, sdpa_calls, peak, clocks = timed_serve(kernels, srv,
                                                             reqs)
        replayed = kernels.replay_counts()
        st = srv.stats()
        where = f"serve_spec {mode} ({arm} arm)"
        check_requests(cfg, reqs, 64)
        if verify is None:
            check_serve_counts(cfg, st, counts, sdpa_calls,
                               "decode_attention", "decode_attention_paged",
                               where)
            check_graph_stats(cfg, st, arm, replayed, "decode_attention",
                              where)
        else:
            check_spec_serve(cfg, st, before, counts, replayed, sdpa_calls,
                             "decode_attention", "decode_attention_paged",
                             verify, arm, where)
        turn = {"arm": arm, "reqs": reqs, "counts": counts,
                "readings": spec_readings(reqs, st, secs, peak, clocks)}
        if verify is not None:
            turn["own_draft_control"] = check_own_draft_control(
                cfg, st, reqs, "hw", verify, where)
        path = f"serve_spec_{mode}" + ("_eager" if arm == "eager" else "")
        counts_by_path.setdefault(path, counts)
        runs[mode].append(turn)
    plain = [r.out for r in mono]
    for mode in ("plain", "scan"):
        for t in runs[mode]:
            for r, want in zip(t["reqs"], plain):
                if list(r.out) != list(want):
                    i = next((i for i, (a, b) in enumerate(zip(r.out, want))
                              if a != b), min(len(r.out), len(want)))
                    fail(f"serve_spec {mode} ({t['arm']}): request {r.rid} "
                         f"({r.group}) leaves the plain serve's tokens at "
                         f"step {i}")
    chunk_vs_plain = [near_tie_compare(
        cfg, params, groups, t["reqs"], plain, "chunk-verify request",
        "the plain serve's tokens") for t in runs["chunk"]]
    timing = {"scan": spec_graph_ms(lambda: server("scan"), requests()[:8],
                                    "eval"),
              "chunk": spec_graph_ms(lambda: server("chunk"),
                                     requests()[:8], "eval")}
    res = {"phase": "serve_spec", "spec_k": SPEC_K, "draft": "vexp_hw",
           "turns": {m: [dict(t["readings"], arm=t["arm"],
                              **({"own_draft_control":
                                  t["own_draft_control"]}
                                 if "own_draft_control" in t else {}))
                         for t in ts] for m, ts in runs.items()},
           "launches": {m: ts[0]["counts"] for m, ts in runs.items()},
           "scan_equals_plain": {"requests": len(plain), "identical": True},
           "chunk_vs_plain": chunk_vs_plain,
           "graph_ms_eval": timing, "sharded_refusal": sharded_refusal,
           "nvidia_smi": smi}
    emit(res)
    return counts_by_path


def phase_serve_paged_spec(kernels, smi, cfg, params, policy, groups,
                           mono):
    """Self-speculative decode on the paged serve's 32 requests (the
    shared 256-token prefix, page 64, 64 new tokens), verify "scan" then
    "chunk", graph arm. Scan tokens equal the plain paged serve's
    (``mono``) request by request, chunk tokens up to a near tie; every
    group attaches prefix pages (hot waves) and the first three hot
    requests of each serve equal themselves served cold and alone (a
    pool without a prefix cache) up to a near tie; the hw control;
    ``assert_idle_clean()``: rollback moves no page. Returns {path:
    launch counts}."""
    from repro_torch.launch.serve import Request, Server
    pol = policy.replace(block_page=PAGE)
    counts_by_path, res = {}, {"phase": "serve_paged_spec", "page": PAGE,
                               "spec_k": SPEC_K, "nvidia_smi": smi}
    for verify in SPEC_VERIFIES:
        grp = spec_policy_groups(groups, verify, PAGE)
        srv = Server(cfg, params, max_batch=8, max_seq=1024, policy=pol,
                     policy_groups=grp, device="cuda", paged=True)
        before = srv.stats()
        reqs = paged_requests(cfg, groups)
        secs, counts, sdpa_calls, peak, clocks = timed_serve(kernels, srv,
                                                             reqs)
        replayed = kernels.replay_counts()
        st = srv.stats()
        where = f"serve_paged_spec {verify}"
        check_requests(cfg, reqs, 64)
        check_spec_serve(cfg, st, before, counts, replayed, sdpa_calls,
                         "decode_attention_paged", "decode_attention",
                         verify, "graph", where)
        for name in groups:
            if st[name]["hot_waves"] < 1:
                fail(f"{where} group {name}: no hot wave")
        srv.assert_idle_clean()
        hot = [r for r in reqs if r.prefix_hit][:3]
        solo_srv = Server(cfg, params, max_batch=8, max_seq=1024,
                          policy=pol, policy_groups=grp, device="cuda",
                          paged=True, prefix_cache=False)
        solos = []
        for r in hot:
            solo = Request(r.rid, r.prompt.copy(), r.max_new, group=r.group)
            solo_srv.run([solo])
            solos.append(solo.out)
        solo_srv.assert_idle_clean()
        if verify == "scan":
            for r, want in zip(reqs, mono):
                if list(r.out) != list(want.out):
                    fail(f"{where}: request {r.rid} ({r.group}) leaves the "
                         f"plain paged serve's tokens")
            vs_plain = {"requests": len(reqs), "identical": True}
        else:
            vs_plain = near_tie_compare(cfg, params, groups, reqs,
                                        [m.out for m in mono],
                                        "paged chunk-verify request",
                                        "the plain paged serve's tokens")
        res[verify] = {
            **spec_readings(reqs, st, secs, peak, clocks),
            "launches": counts, "vs_plain": vs_plain,
            "hot_requests": sum(1 for r in reqs if r.prefix_hit),
            "hot_equals_cold_solo": near_tie_compare(
                cfg, params, groups, hot, solos, "hot speculating request",
                "its cold solo tokens"),
            "own_draft_control": check_own_draft_control(
                cfg, st, reqs, "hw", verify, where),
            "pool": {n: st[n]["pool"] for n in groups}}
        counts_by_path[f"serve_paged_spec_{verify}"] = counts
    emit(res)
    return counts_by_path


CHAOS_SEED = 0
CHAOS_BUDGET = 1 + 4 * 16      # four full 16-page reservations a group


def chaos_requests(cfg, groups):
    """18 requests on the paged serve's shared 256-token prefix with a
    [32, 256]-token suffix, 16 new tokens each (seed 4); the last one
    with a 1 ms deadline, which expires while it waits."""
    from repro_torch.launch.serve import make_requests
    reqs = make_requests(cfg, 18, 256, 16, mixed_lengths=True, min_len=32,
                         groups=sorted(groups), seed=4, shared_prefix=256)
    reqs[-1].deadline_s = 1e-3
    return reqs


def phase_serve_chaos(kernels, smi, cfg, params, policy, groups):
    """Paged, chunked (96) serving under a seeded FaultInjector at
    ``default_chaos_rates()`` over all six points, with a 65-page budget
    per group (four full reservations: the pool comes under pressure),
    ``degrade_groups=("bulk",)``, request 0 cancelled mid-chunk and the
    last request given a deadline that expires; graph arm. Checks every
    request ends with a reason, no quarantined request streams a token
    (and no served one a -1), step-fault victims outside the degraded
    group are re-served with an undisturbed serve's tokens (near ties
    aside), the ladder reaches L2 and comes back to 0 (idle ticks after
    the drain), and ``check_invariants()`` / ``assert_idle_clean()``.
    Returns {path: launch counts}."""
    from repro_torch.ft import FaultInjector, default_chaos_rates
    from repro_torch.launch.serve import RESTORE_AFTER, Request, Server
    pol, grp = chunked_groups(policy, groups, 96, PAGE)
    inj = FaultInjector(seed=CHAOS_SEED, rates=default_chaos_rates())
    srv = Server(cfg, params, max_batch=8, max_seq=1024, policy=pol,
                 policy_groups=grp, device="cuda", paged=True,
                 block_budget=CHAOS_BUDGET, injector=inj,
                 degrade_groups=("bulk",))
    reqs = chaos_requests(cfg, groups)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    g0 = srv._groups[reqs[0].group]
    for _ in range(50):               # until request 0 streams its prompt
        srv.step()
        if 0 in [r.rid for r, _ in g0.prefilling.values()]:
            break
    else:
        fail("chaos: request 0 never reached chunked prefill")
    srv.cancel(reqs[0].rid)
    srv.drain()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check_serve_counts(cfg, srv.stats(), counts, 0,
                       "decode_attention_paged", "decode_attention",
                       "serve_chaos")
    peak = srv.fault_stats()["degrade_peak"]
    idle_ticks = 0
    while srv.degrade_level and idle_ticks < 4 * RESTORE_AFTER:
        srv.step()
        idle_ticks += 1
    fs = srv.fault_stats()
    st = srv.stats()
    reasons = {}
    for r in reqs:
        reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
        if r.finish_reason is None:
            fail(f"chaos: request {r.rid} ended without a reason")
        if r.finish_reason in ("max_new", "length_cap"):
            if len(r.out) != r.max_new or min(r.out) < 0:
                fail(f"chaos: served request {r.rid} has {len(r.out)} "
                     f"tokens, min {min(r.out, default=None)}")
        elif r.out:
            fail(f"chaos: request {r.rid} ({r.finish_reason}) streamed "
                 f"{len(r.out)} tokens")
    if reqs[0].finish_reason != "cancelled":
        fail(f"chaos: request 0 ended {reqs[0].finish_reason}, not "
             f"cancelled")
    if reqs[-1].finish_reason != "deadline":
        fail(f"chaos: request {reqs[-1].rid} ended "
             f"{reqs[-1].finish_reason}, not at its deadline")
    if peak < 2 or fs["degrade_level"]:
        fail(f"chaos: the ladder peaked at {peak} and ended at "
             f"{fs['degrade_level']} after {idle_ticks} idle ticks (want 2, "
             f"then 0)")
    srv.check_invariants()
    srv.assert_idle_clean()
    victims = [r for r in reqs if r.retries and r.group != "bulk"
               and r.finish_reason == "max_new"]
    base = Server(cfg, params, max_batch=8, max_seq=1024, policy=pol,
                  policy_groups=grp, device="cuda", paged=True)
    calm = [Request(r.rid, r.prompt.copy(), r.max_new, group=r.group)
            for r in victims]
    base.run(calm)
    res = {"phase": "serve_chaos", "seed": CHAOS_SEED,
           "rates": default_chaos_rates(), "block_budget": CHAOS_BUDGET,
           "requests": len(reqs), "seconds": secs,
           "finish_reasons": reasons, "injector": fs["injector"],
           "degrade_peak": peak, "degrade_level_end": fs["degrade_level"],
           "idle_ticks_to_restore": idle_ticks,
           "lifecycle": {n: {k: st[n][k] for k in (
               "cancelled", "deadline_missed", "quarantined", "step_faults",
               "requeued", "shed", "admit_retries", "prefill_chunks",
               "decode_steps", "decode_steps_prefilling",
               "graph_captures", "chunk_graph_captures")}
               for n in st},
           "step_fault_victims": [r.rid for r in victims],
           "victims_equal_undisturbed": near_tie_compare(
               cfg, params, grp, victims, [c.out for c in calm],
               "re-served request", "its undisturbed tokens"),
           "launches": counts, "nvidia_smi": smi}
    emit(res)
    print(f"[chip_smoke] chaos injector: {json.dumps(fs['injector'])}",
          flush=True)
    return {"serve_chaos": counts}


# The sharded serves: 2 ranks on the one card (NCCL refuses two ranks on
# one device, so gloo, with the CUDA tensors staged through host memory),
# each a process of its own, joined through a file:// store.
SHARD_RANKS = 2
SHARD_TIMEOUT_S = 300          # the process group's collective timeout
SHARD_JOIN_S = 900             # the whole spawned phase
SHARD_LABEL = "2 ranks on one card, gloo, host-staged collectives"
MERGE = {"eval": "split", "bulk": "packed", "hw": "packed"}


def sharded_groups(groups):
    """The policy groups with their merge strategies: eval=exact splits,
    bulk=vexp and hw=vexp_hw pack, so every partial and packed kernel
    runs on a serve path; pages of PAGE tokens."""
    return {n: p.replace(merge_strategy=MERGE[n], block_page=PAGE)
            for n, p in groups.items()}


def contiguous_sharded_requests(cfg, groups):
    """16 requests, prompts in [32, 896] (seed 0): rows that stay inside
    shard 0 and rows that straddle the 512-position boundary."""
    from repro_torch.launch.serve import make_requests
    return make_requests(cfg, 16, 896, 64, mixed_lengths=True, min_len=32,
                         groups=sorted(groups), seed=0)


def paged_requests(cfg, groups, seed=0):
    """The paged phase's 32 requests: one shared 256-token prefix plus a
    suffix of [32, 256] tokens, 64 new tokens each."""
    from repro_torch.launch.serve import make_requests
    return make_requests(cfg, 32, 256, 64, mixed_lengths=True, min_len=32,
                         groups=sorted(groups), seed=seed, shared_prefix=256)


def _sharded_rank(rank, world, store, out_path):
    """One rank of phase_serve_sharded (a spawned process): joins the
    group, serves the contiguous then the paged request set through
    Server(kv_mode="seq"), and writes its tokens, counts and stats to
    ``out_path``. Any failure raises, so the process exits non-zero."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import kernels
    from repro_torch.distributed import init_shard_group
    from repro_torch.launch.serve import Server, make_requests
    from repro_torch.runtime import resolve_device
    resolve_device("cuda")
    torch.cuda.set_device(0)
    comm = init_shard_group(f"file://{store}", rank, world, device="cuda",
                            timeout_s=SHARD_TIMEOUT_S)
    cfg, params, policy, groups = gpt2_small_setup()
    policy = policy.replace(block_page=PAGE)
    groups = sharded_groups(groups)
    out = {"rank": rank, "backend": comm.backend,
           "host_staged": comm.host_staged}
    for path, paged in (("serve_sharded", False),
                        ("serve_paged_sharded", True)):
        def server():
            return Server(cfg, params, max_batch=8, max_seq=1024,
                          policy=policy, policy_groups=groups, device="cuda",
                          paged=paged, kv_mode="seq", shards=comm)
        server().run(make_requests(cfg, 3, 64, 4, groups=sorted(groups),
                                   seed=1))               # warm-up
        srv = server()
        reqs = (paged_requests(cfg, groups) if paged
                else contiguous_sharded_requests(cfg, groups))
        secs, counts, sdpa_calls, peak, clocks = timed_serve(kernels, srv,
                                                             reqs)
        st = srv.stats()
        srv.assert_idle_clean()
        out[path] = {"tokens": [r.out for r in reqs],
                     "finish": [r.finish_reason for r in reqs],
                     "prefix_hit": [r.prefix_hit for r in reqs],
                     "metrics": serve_metrics(reqs, secs),
                     "launches": counts, "sdpa_calls": sdpa_calls,
                     "peak_memory_bytes": peak, "clocks_power": clocks,
                     "stats": st}
    with open(out_path, "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def _spawn_ranks(world):
    """Run _sharded_rank on ``world`` spawned processes; every one must
    exit 0 within SHARD_JOIN_S. Returns their results in rank order."""
    import multiprocessing as mp
    import tempfile
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [ctx.Process(target=_sharded_rank,
                             args=(r, world, os.path.join(tmp, "store"),
                                   paths[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARD_JOIN_S
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        if hung:
            fail(f"sharded serve: ranks {hung} still running after "
                 f"{SHARD_JOIN_S} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            fail(f"sharded serve: rank exit codes {codes}")
        out = []
        for path in paths:
            with open(path) as f:
                out.append(json.load(f))
        return out


def phase_serve_sharded(kernels, smi, cfg, params, policy, groups,
                        paged_reqs):
    """Sequence-sharded serving (kv_mode="seq") of full-width gpt2-small
    on 2 ranks of the one card: max_batch 8, max_seq 1024 (512 positions
    per rank), 64 new tokens, groups eval=exact (merge split), bulk=vexp
    and hw=vexp_hw (packed). First the contiguous cache on 16 requests
    with prompts in [32, 896], then the paged pool (page 64, 8 pages per
    rank per slot) on the paged phase's 32 shared-prefix requests. Checks
    every rank's tokens equal, each request's tokens equal to the same
    request served unsharded (``paged_reqs``: the paged phase's) under
    the near-tie rule, partial / packed launches = layers x decode steps
    per merge strategy, no unsharded decode launch and no SDPA call,
    12 or 36 collectives per step, prefix hits in every paged group, and
    (in each rank) assert_idle_clean. Returns {path: rank 0's counts}."""
    from repro_torch.launch.serve import Request, Server
    groups = sharded_groups(groups)
    ranks = _spawn_ranks(SHARD_RANKS)
    base_reqs = contiguous_sharded_requests(cfg, groups)
    Server(cfg, params, max_batch=8, max_seq=1024, policy=policy,
           policy_groups=groups, device="cuda").run(base_reqs)
    baselines = {"serve_sharded": base_reqs,
                 "serve_paged_sharded": paged_reqs}
    kernel_of = {"serve_sharded": ("decode_attention_partial",
                                   "decode_attention_packed",
                                   "decode_attention"),
                 "serve_paged_sharded": ("decode_attention_paged_partial",
                                         "decode_attention_paged_packed",
                                         "decode_attention_paged")}
    by_path = {}
    for path, base in baselines.items():
        r0 = ranks[0][path]
        for other in ranks[1:]:
            if other[path]["tokens"] != r0["tokens"]:
                fail(f"{path}: rank {other['rank']}'s tokens differ from "
                     f"rank 0's")
        reqs = [Request(b.rid, b.prompt, len(t), group=b.group, out=t,
                        finish_reason=f)
                for b, t, f in zip(base, r0["tokens"], r0["finish"])]
        check_requests(cfg, reqs, 64)
        st, counts = r0["stats"], r0["launches"]
        partial, packed, whole = kernel_of[path]
        steps = {m: sum(st[n]["decode_steps"] for n in st
                        if st[n]["merge_strategy"] == m)
                 for m in ("split", "packed")}
        for n, g in st.items():
            if g["shards"] != SHARD_RANKS:
                fail(f"{path} group {n}: {g['shards']} shards, not "
                     f"{SHARD_RANKS}")
            if g["graph_captures"] or g["graph_replays"]:
                fail(f"{path} group {n}: a sharded step was captured "
                     f"({g['graph_captures']} captures); it must run "
                     f"eagerly")
            per = cfg.n_layers * (3 if g["merge_strategy"] == "split" else 1)
            if g["collectives"] != per * g["decode_steps"]:
                fail(f"{path} group {n}: {g['collectives']} collectives in "
                     f"{g['decode_steps']} decode steps, not {per} a step")
        for name, m in ((partial, "split"), (packed, "packed")):
            if counts[name] != cfg.n_layers * steps[m] or not steps[m]:
                fail(f"{path}: {name} launches {counts[name]} != "
                     f"{cfg.n_layers} layers x {steps[m]} {m} decode steps")
        if counts[whole] or r0["sdpa_calls"]:
            fail(f"{path}: {counts[whole]} unsharded decode launches, "
                 f"{r0['sdpa_calls']} SDPA calls")
        if path == "serve_paged_sharded":
            for n in groups:
                if st[n]["pool"]["prefix"]["hits"] <= 0:
                    fail(f"{path} group {n}: no prefix hits")
        res = {"phase": path, "label": SHARD_LABEL, "ranks": SHARD_RANKS,
               "backend": ranks[0]["backend"],
               "host_staged": ranks[0]["host_staged"],
               **r0["metrics"],
               "p50_host_dispatch_s": {n: st[n]["p50_host_dispatch_s"]
                                       for n in groups},
               "step_mode": {n: st[n]["step_mode"] for n in groups},
               "decode_steps": {n: st[n]["decode_steps"] for n in groups},
               "collectives_per_step": {n: st[n]["collectives_per_step"]
                                        for n in groups},
               "merge_strategy": {n: st[n]["merge_strategy"]
                                  for n in groups},
               "launches": counts,
               "peak_memory_bytes_by_rank": [r[path]["peak_memory_bytes"]
                                             for r in ranks],
               "tok_s_by_rank": [r[path]["metrics"]["tok_s"]
                                 for r in ranks],
               "clocks_power": r0["clocks_power"],
               "prompt_lens": [len(r.prompt) for r in reqs],
               "nvidia_smi": smi}
        if path == "serve_paged_sharded":
            res["prefix_hits"] = {n: st[n]["pool"]["prefix"]["hits"]
                                  for n in groups}
            res["hot_requests"] = sum(1 for h in r0["prefix_hit"] if h)
        res["equals_unsharded"] = near_tie_compare(
            cfg, params, groups, reqs, [b.out for b in base],
            "sharded request", "its unsharded tokens")
        emit(res)
        by_path[path] = counts
    return by_path


DECODE_LIBS = ("decode_attention", "decode_attention_paged")


def profile_serve(kernels, make_server, reqs, what):
    """Device busy share and kernel time by name over one short serve
    (torch.profiler, CUDA activity). Fails unless the trace holds every
    decode launch the serve counted (one ``split_scores`` kernel each,
    replayed ones included), so the counted replays ran."""
    from torch.profiler import ProfilerActivity, profile
    srv = make_server()
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.run(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    after = kernels.launch_counts()
    launched = sum(after[n] - before[n] for n in DECODE_LIBS)
    traced = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "split_scores" in e.name)
    by_name, busy = {}, 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    held = {"decode_launches": launched,
            "decode_kernels_in_trace": traced}
    if not launched or traced != launched:
        fail(f"{what} profile: the trace holds {traced} split_scores "
             f"kernels for {launched} counted decode launches")
    st = srv.stats()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_s": wall_us / 1e6, "device_busy_s": busy / 1e6,
            "device_busy_share": busy / wall_us, **held,
            "decode_steps": sum(g["decode_steps"] for g in st.values()),
            "admit_waves": sum(g["admit_waves"] for g in st.values()),
            "device_events": sum(1 for e in prof.events()
                                 if e.device_type
                                 == torch.autograd.DeviceType.CUDA),
            "top_kernels_s": {k[:80]: v / 1e6 for k, v in top}}


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch import kernels
        from repro_torch.runtime import ExecPolicy, resolve_device
    except ImportError as e:
        fail(f"cannot import the port from {HERE}/src: {e}")
    resolve_device("cuda")
    smi = phase_build(kernels)
    rows = [phase_vexp(kernels, ExecPolicy), phase_softmax(ExecPolicy)]
    cfg, params, policy, groups = gpt2_small_setup()
    rows.append(phase_flash_attention(ExecPolicy, policy.block_k))
    rows.append(phase_decode(ExecPolicy))
    rows.append(phase_paged_decode(ExecPolicy))
    rows.extend(phase_sharded_decode(ExecPolicy))
    # each serve path runs with the counts set to 0 just before it and
    # read just after; a kernel's launches are the sum over the paths,
    # and launches_by_path keeps each run's own count (replayed launches
    # included; the eager arms are paths of their own; a sharded path's
    # from rank 0, whose counts equal every rank's)
    by_path, mono = phase_serve(kernels, smi, cfg, params, policy, groups)
    paged_counts, paged_reqs = phase_serve_paged(kernels, smi, cfg, params,
                                                 policy, groups)
    by_path.update(paged_counts)
    by_path.update(phase_serve_chunked(kernels, smi, cfg, params, policy,
                                       groups, mono))
    by_path.update(phase_serve_paged_chunked(kernels, smi, cfg, params,
                                             policy, groups, paged_reqs))
    by_path.update(phase_serve_chaos(kernels, smi, cfg, params, policy,
                                     groups))
    by_path.update(phase_serve_spec(kernels, smi, cfg, params, policy,
                                    groups, mono))
    by_path.update(phase_serve_paged_spec(kernels, smi, cfg, params, policy,
                                          groups, paged_reqs))
    by_path.update(phase_serve_sharded(kernels, smi, cfg, params, policy,
                                       groups, paged_reqs))
    for row, name in zip(rows, ("vexp", "softmax", "flash_attention",
                                "decode_attention",
                                "decode_attention_paged",
                                "decode_attention_partial",
                                "decode_attention_packed",
                                "decode_attention_paged_partial",
                                "decode_attention_paged_packed")):
        row["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
