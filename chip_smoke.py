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
to the eager step by the capture audit; the paged serve's cold requests
held to a contiguous serve at the page's update block request by
request), both again with chunked
prefill (each group's chunk program a second CUDA graph; tokens held to
the monolithic serves'), a chaos serve (paged, chunked, a seeded fault
injector at all six points, a squeezed page budget, the degradation
ladder, a cancel and a deadline), then serves it sequence-sharded (``kv_mode="seq"``) on 2 ranks spawned on the
one card (gloo, host-staged collectives), then self-speculatively on both
pools (spec_k = 4, drafts under vexp_hw, verify "scan" and "chunk",
each burst k draft-step replays and one verify replay; scan tokens held
to the plain serves' request by request, chunk tokens up to a near
tie, the hw group's own-backend drafts as a control), then trains
full-width gpt2-small through ``repro_torch.launch.train`` (B3's and
B1's autograd Functions held to autograd of their plain versions bit
for bit at the step's shapes; the loss falls, a resumed run repeats an
uninterrupted one's losses bit for bit, the preemption drain, cuda vs
reference tier, every exp backend, the step's time, memory and busy
share; 12 B3 launches a step, none in the backward), then serves
full-width mamba2-1.3b (the ssm family, attention-free, every gate exp
one launch of the exp kernel) the same three ways: monolithic (graph and
eager arms in turns, the capture audit, the decode step's graph ms per
exp backend on the cuda and the reference tier, the gate exps held to
their plain versions, cuda tier against reference tier and the SSD's two
forms against each other over a teacher-forced replay), chunked (256)
and self-speculative (k = 4, the recurrent scan verify; tokens held to
the plain serve's), then the RG-LRU hybrid recurrentgemma-9b at full
width (B3 / B2 / B7 at head dim 256), then the SwiGLU dense decoder
phi3-medium-14b at full width: B3 / B2 / B7 at its head dim 128 (40
query heads on 10 KV heads) held to their plain versions with their
controls, and its serves (graph and eager arms in turns, paged, chunked
256; every SwiGLU gate exp one launch of the exp kernel, held to its
plain version over a teacher-forced replay), then the MoE family,
dbrx-132b at full width with its depth cut to 8 layers: B3 / B2 / B7 at
48 query heads on 8 KV heads (G 6) with their controls, its serve (graph
then eager, the router's and the experts' gate exps two launches of the
exp kernel a layer, held to their plain versions over a teacher-forced
replay, the tiers' routing flips counted) and its paged serve held to a
contiguous one request by request, then the sliding-window dense decoder
h2o-danube3-4b at full width: B3 / B2 / B7 at its head dim 120 (the
head-dim-128 kernels on zero-filled columns; 32 query heads on 8 KV
heads, a 4,096-token wave and ring) with their controls and edges, its
serve on the 4,096-slot ring (one request a group at the window, so
every group's decode wraps; graph then eager) and its paged ring serve
held to a ring serve request by request, and checks what comes out.
Every phase prints one JSON line; the first failure on any rank exits
non-zero.
The last two lines are the kernel table and the device line. Without a
CUDA device, or without the rest of the checkout, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import gc
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


T_START = time.perf_counter()


def emit(obj: dict):
    """One JSON line; a phase's line also carries the seconds since the
    script started (``elapsed_s``), from which each phase's own seconds
    follow."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
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
    """(max |out - ref|, share of outputs whose bits differ, max |out -
    ref| over the outputs more than one bf16 ulp apart) over the outputs
    that the boolean ``real`` (broadcast to ``out``) selects."""
    from repro_torch.kernels.limits import beyond_one_ulp
    o, r = out, ref
    if real is not None:
        sel = real.expand_as(o)
        o, r = o[sel], r[sel]
    return (float((o.float() - r.float()).abs().max()),
            float((o.float() != r.float()).double().mean()),
            beyond_one_ulp(o, r))


def check_attention(kernel, readings, where=""):
    """Fail unless every backend's kernel reading is inside ATT_LIMITS and
    every negative control is outside them: the plain version at half the
    online-update unit (block or page), for the decode kernels the
    textbook split-KV merge (``textbook_partial``), and for FA the scan
    with p in two bf16 terms against the same scan with p exact.
    ``readings`` maps (exp, "kernel" | "half_block" | "half_page" |
    "textbook_merge" | "p_two_terms") to ``kernel_vs_plain``'s
    (max_abs_err, mismatch_share, max_abs_err beyond one bf16 ulp); the
    last stands for the first where ONE_ULP_FREE names the kernel and
    exp."""
    from repro_torch.kernels.limits import ATT_LIMITS, ONE_ULP_FREE
    for (exp, who), (err, share, far) in readings.items():
        lim_err, lim_share = ATT_LIMITS[kernel][exp]
        if exp in ONE_ULP_FREE.get(kernel, ()):
            err = far
        inside = err <= lim_err and share <= lim_share
        if who == "kernel" and not inside:
            fail(f"{kernel}{where} {exp}: kernel off its plain version by "
                 f"{err} (limit {lim_err}), {share} of outputs differ "
                 f"(limit {lim_share})")
        if who != "kernel" and inside:
            fail(f"{kernel}{where} {exp}: the negative control {who} passes "
                 f"the limits ({err}, {share}); they cannot see that fault")


def textbook_partial(q, k_cache, v_cache, cache_len, seq_offset, *, layout,
                     exp, window=None):
    """Negative control for the split decode kernels: the usual split-KV
    merge over the same 64-key tiles (each update block's keys from its
    start in steps of 64; the slice and the block are whole tiles here),
    each tile's p taken against the tile's own max and the tiles folded
    with one exp(m_t - m) each, keys outside the window masked as the
    kernels mask them. Under vexp and vexp_hw
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
    kpos = (seq_offset + torch.arange(smax, device=q.device))[None, :]
    keep = kpos < cache_len.reshape(-1, 1)
    if window is not None:
        keep = keep & (kpos >= cache_len.reshape(-1, 1) - window)
    keep = keep[:, None, None]
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


def _sdpa_mask_prefill(kv_len, sq, sk, q_offset=0, window=None):
    qpos = _qpos(sq, q_offset)[:, :, None]
    kpos = torch.arange(sk, device="cuda")[None, None, :]
    keep = (kpos <= qpos) & (kpos < kv_len[:, None, None])
    if window is not None:
        keep = keep & (kpos > qpos - window)
    return keep[:, None]


def _kv_heads(t, h):
    """(B, Hkv, S, D) K or V for h query heads: as it is where it
    broadcasts (Hkv 1 or h), else each KV head repeated for its h / Hkv
    consecutive query heads (GQA)."""
    hkv = t.shape[1]
    return t if hkv in (1, h) else t.repeat_interleave(h // hkv, dim=1)


def _scan_p_terms(q, k, v, kv_len, q_offset, block_k, exp, terms,
                  window=None):
    """The plain scan (causal, keys below kv_len and inside the window,
    queries at q_offset + i) with p rounded to its ``terms`` leading bf16
    terms in p . v: what a tensor-core kernel that splits p too few times
    computes."""
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
        kb = _kv_heads(k[:, k0:k0 + block_k].float().transpose(1, 2), h)
        vb = _kv_heads(v[:, k0:k0 + block_k].float().transpose(1, 2), h)
        kpos = k0 + torch.arange(kb.shape[2], device=q.device)
        keep = (kpos <= qpos) & (kpos < kv_len[:, None, None, None])
        if window is not None:
            keep = keep & (kpos > qpos - window)
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


def _truth64(q, k, v, kv_len, q_offset, window=None):
    """Causal attention under the exact exp in float64, one pass, rounded
    to bf16 once: what an exact evaluation of the function gives."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    kd, vd = _kv_heads(kd, h), _kv_heads(vd, h)
    sc = qd @ kd.transpose(-1, -2) * (1.0 / d ** 0.5)
    qpos = _qpos(sq, q_offset)[:, None, :, None]      # (1|B, 1, Sq, 1)
    kpos = torch.arange(sk, device=q.device)
    keep = (kpos <= qpos) & (kpos < kv_len[:, None, None, None])
    if window is not None:
        keep = keep & (kpos > qpos - window)
    sc = torch.where(keep, sc, -1e300)
    p = torch.where(keep, torch.exp(sc - sc.amax(-1, keepdim=True)), 0.0)
    out = (p @ vd) / p.sum(-1, keepdim=True).clamp_min(1e-300)
    return out.transpose(1, 2).to(q.dtype)


def _fa_readings(fa, policy_cls, block_k, q, k, v, kv_len, q_offset,
                 window=None, truth=False):
    """The kernel against its plain version per backend over the real
    query rows (those below kv_len), with the controls: the plain version
    at half the block (vexp, vexp_hw) and the scan with p in two bf16
    terms against the same scan with p exact (exact, vexp); both must
    fail the limits. With ``truth``, also the kernel and the plain
    version against a float64 evaluation under the exact exp (share of
    outputs changed). Returns (readings, {who: share})."""
    sq = q.shape[1]
    real = (_qpos(sq, q_offset) < kv_len[:, None])[:, :, None, None]
    kw = dict(causal=True, kv_len=kv_len, q_offset=q_offset)
    if window is not None:
        kw["window"] = window
    readings, shares = {}, {}
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
                                        exp, n, window) for n in (2, 3))
            readings[exp, "p_two_terms"] = kernel_vs_plain(two, three, real)
        if exp == "exact" and truth:
            t64 = _truth64(q, k, v, kv_len, q_offset, window)
            for who, o in (("plain", ref), ("kernel", out)):
                shares[who] = kernel_vs_plain(o, t64, real)[1]
    return readings, shares


def _fa_case(fa, policy_cls, block_k, q, k, v, kv_len, q_offset, tag,
             window=None, truth=True, iters=20):
    """One FA case. The kernel vs the plain version per backend, and the
    plain version at half the block and with p in two bf16 terms (both
    must fail the limits); under the exact exp, both the kernel and the
    plain version vs a float64 evaluation (reported). Times (eager and
    graph), the library call's and the bound. Query i of row b sits at
    q_offset + i; its real rows are those below kv_len[b]; with a
    ``window`` it keeps the keys above its position minus the window.
    K and V may have fewer heads than q (GQA / MQA). ``truth`` False
    leaves out the float64 evaluation (its score matrix would not fit the
    card at h2o-danube3's 4,096-token wave); ``iters`` calls a timing
    (the plain version's a quarter of them, at least two). Returns
    (fields, limit readings)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qpos = _qpos(sq, q_offset)
    kw = dict(causal=True, kv_len=kv_len, q_offset=q_offset)
    if window is not None:
        kw["window"] = window
    readings, truth = _fa_readings(fa, policy_cls, block_k, q, k, v,
                                   kv_len, q_offset, window, truth=truth)
    res = {f"{tag}exact_{who}_vs_f64_mismatch_share": share
           for who, share in truth.items()}
    for (exp, who), (err, share, _) in readings.items():
        res[f"{tag}{exp}_{who}_max_abs_err"] = err
        res[f"{tag}{exp}_{who}_mismatch_share"] = share
    with SmiSampler() as smi:
        for exp in ("exact", "vexp_hw", "vexp"):  # vexp last: the row's ms
            pol = policy_cls(exp_backend=exp, block_k=block_k)
            res[f"{tag}ms_{exp}"] = cuda_time_ms(
                lambda: fa.flash_attention(q, k, v, policy=pol, **kw),
                iters=iters)
        res[f"{tag}graph_ms_vexp"] = graph_ms(
            lambda: fa.flash_attention(q, k, v, policy=pol, **kw),
            f"flash_attention {tag}", iters=iters)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
        q, k, v, block_k=block_k, exp_backend="vexp", **kw),
        iters=max(2, iters // 4), warmup=1 if iters < 20 else 3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = _sdpa_mask_prefill(kv_len, sq, k.shape[1], q_offset, window)
    gqa = {"enable_gqa": True} if hkv != h else {}

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, **gqa)
    lib_ms = cuda_time_ms(sdpa, iters=iters)
    lib_g_ms = graph_ms(sdpa, f"sdpa {tag}", iters=iters)
    # the function's work: every query row attends, causally, to the keys
    # below its row's kv_len (and inside the window); q and o move whole,
    # K and V (Hkv heads) up to kv_len
    lo = (torch.zeros_like(qpos) if window is None
          else torch.clamp(qpos - window + 1, min=0))
    pairs = float((torch.minimum(qpos.double() + 1, kv_len.double()[:, None])
                   - lo.double()).clamp(min=0).sum())
    flops = 4.0 * h * d * pairs
    live = float(kv_len.double().sum())
    nbytes = 2 * b * sq * h * d * 2 + 2 * live * hkv * d * 2
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    # a reading, not a bound: the same multiply-adds (one a pair and a
    # head per d for the score, one for p . v) at one FMA a clock on each
    # of an SM's 128 f32 lanes, at the SM clock sampled while timing
    clk = smi.summary()
    clk = clk["clocks_sm_mhz"]["median"] if isinstance(clk, dict) else None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res.update({f"{tag}plain_ms_vexp": plain_ms, f"{tag}library_ms": lib_ms,
                f"{tag}library_graph_ms": lib_g_ms,
                f"{tag}bound_ms": b_ms, f"{tag}bound_by": b_by,
                f"{tag}sm_clock_mhz": clk if clk else "not measured",
                f"{tag}fma_floor_ms": (flops / 2 / (sms * 128 * clk * 1e6)
                                       * 1e3 if clk else "not measured"),
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
                for (_, who), (err, *_) in rd.items() if who == "kernel")
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
        for (exp, who), (err, share, _) in readings.items():
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
        for (exp, who), (err, share, _) in readings.items():
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
                for (exp, who), (err, share, _) in readings.items():
                    res[f"{tag}{exp}_{who}_max_abs_err"] = err
                    res[f"{tag}{exp}_{who}_mismatch_share"] = share
                res.update({f"{tag}{exp}_fold_max_abs_err": e
                            for exp, e in fold.items()})
                worst[kind] = max([worst[kind]] + [
                    err for (_, who), (err, *_) in readings.items()
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


def replay_logits(cfg, params, reqs, policy, steps=None, width=None):
    """Teacher-forced logits of ``reqs`` (prompts + their emitted tokens)
    under ``policy``: one ragged prefill (at ``width`` padded positions
    where given, else the longest prompt's), then one decode step per
    emitted token (the first ``steps`` logits only, where given). Returns
    a list of (B, V) f32 logits per step."""
    from repro_torch.models import transformer
    b = len(reqs)
    plen = np.array([len(r.prompt) for r in reqs], np.int32)
    toks = np.zeros((b, width or int(plen.max())), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :plen[i]] = r.prompt
    n = steps or len(reqs[0].out)
    logits, pref = transformer.prefill(
        params, cfg, torch.as_tensor(toks, device="cuda"),
        prompt_len=torch.as_tensor(plen, device="cuda"), policy=policy)
    cache = transformer.init_cache(
        cfg, b, max(toks.shape[1], int(plen.max()) + n), "cuda")
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


def replay_logits_paged(cfg, params, reqs, policy, hist_len, page,
                        steps=None):
    """Teacher-forced logits of ``reqs`` through the paged path, as a hot
    admission serves them: the shared ``hist_len``-token prefix (whole
    pages) prefilled once into pool pages that every row's table
    shares, each row's suffix prefilled against that history (attention
    at q_offset=hist_len), then one paged decode step per emitted token
    (the first ``steps`` logits only, where given). Returns a list of
    (B, V) f32 logits per step."""
    from repro_torch.models import transformer
    from repro_torch.models.decode_state import (_paged_gather_hist,
                                                 _paged_scatter)
    b, lay = len(reqs), cfg.kv_cache_layout
    n = steps or len(reqs[0].out)
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
# gpt2's replays (serve, paged): the first 16 of each request's 64
# tokens forced, as phi3's and dbrx's tier checks take
GPT2_REPLAY_STEPS = 16


def check_replay(name, reqs, fast, ref, limit=None):
    """cuda-tier logits within ``limit`` (default REPLAY_LOGIT_TOL) of the
    reference tier's, finite, and every served token the reference argmax
    wherever the reference's top two logits are more than 2 x the limit
    apart."""
    limit = REPLAY_LOGIT_TOL if limit is None else limit
    d = max(float((a - b).abs().max()) for a, b in zip(fast, ref))
    if not all(bool(torch.isfinite(a).all()) for a in fast):
        fail(f"replay {name}: non-finite logits")
    if d > limit:
        fail(f"replay {name}: cuda vs reference tier logits differ by {d} "
             f"(limit {limit})")
    for i, r in enumerate(reqs):
        for t, lg in enumerate(ref):
            top = torch.topk(lg[i], 2).values
            if float(top[0] - top[1]) > 2 * limit and \
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


def near_tie_compare(cfg, params, groups, reqs, others, what, against,
                     check=True):
    """Each request's tokens against ``others`` (the same request served
    another way): equal, or diverging first at a step where the reference
    tier's top-2 logit gap is a near tie (<= 2 x REPLAY_LOGIT_TOL).
    Returns the counts; fails on a divergence that is not a near tie
    (with ``check`` False only records it)."""
    from repro_torch.models import api
    near_ties, same = [], 0
    for r, other in zip(reqs, others):
        diff = [i for i, (a, b) in enumerate(zip(r.out, other)) if a != b]
        if not diff and len(r.out) == len(other):
            same += 1
            continue
        i = diff[0] if diff else min(len(r.out), len(other))
        seq = np.concatenate([r.prompt, np.asarray(other[:i], np.int32)])
        lg, _ = api.prefill(
            params, cfg, {"tokens": seq[None]},
            policy=groups[r.group].replace(kernel_backend="reference"),
            device="cuda")
        top = torch.topk(lg[0, 0], 2).values
        gap = float(top[0] - top[1])
        if check and gap > 2 * REPLAY_LOGIT_TOL:
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
# turns of each serve path's arms: one (graph, then eager), so that the
# run keeps inside its limit as paths are added; every arm and every
# comparison still runs once
ARM_TURNS = 1


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


def serve_turn(kernels, cfg, make_server, make_reqs, arm, decode, other,
               what, after=None):
    """One serve of ``make_reqs()`` through ``make_server(arm ==
    "graph")``, its launch counts set to 0 just before and read just
    after and checked (``check_serve_counts``, ``check_graph_stats``);
    ``after(srv, stats)`` runs on the drained server. Returns the turn: a
    dict with the requests, stats, counts and readings."""
    srv = make_server(arm == "graph")
    reqs = make_reqs()
    secs, counts, sdpa_calls, peak, clocks = timed_serve(kernels, srv, reqs)
    replayed = kernels.replay_counts()
    st = srv.stats()
    where = f"{what} ({arm} arm)"
    waves, chunks, steps = check_serve_counts(
        cfg, st, counts, sdpa_calls, decode, other, where)
    graphs = check_graph_stats(cfg, st, arm, replayed, decode, where)
    if after is not None:
        after(srv, st)
    some = next(iter(st.values()))
    return {
        "reqs": reqs, "stats": st, "counts": counts,
        "readings": {
            **serve_metrics(reqs, secs),
            "wall_per_decode_step_s": some["wall_per_decode_step_s"],
            "p50_host_dispatch_s": {
                n: s["p50_host_dispatch_s"] for n, s in st.items()
                if s["decode_steps"]},
            "admit_s_total": sum(s["admit_s_total"] for s in st.values()),
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
            "chunk_graph_captures": sum(v[2] for v in graphs.values()),
            "chunk_graph_replays": sum(v[3] for v in graphs.values()),
            "chunk_graph_capture_s": sum(s["chunk_graph_capture_s"]
                                         for s in st.values()),
            "replayed_launches": replayed[decode],
            "replayed_flash_attention": replayed["flash_attention"],
            "peak_memory_bytes": peak, "clocks_power": clocks}}


def serve_in_turns(kernels, cfg, make_server, make_reqs, decode, other,
                   what, after=None):
    """``serve_turn`` with graphs and eagerly, in turns (ARM_TURNS of
    graph, eager). Returns {arm: [turn, ...]}."""
    runs = {arm: [] for arm in ARMS}
    for _ in range(ARM_TURNS):
        for arm in ARMS:
            runs[arm].append(serve_turn(kernels, cfg, make_server, make_reqs,
                                        arm, decode, other, what, after))
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
    t0 = time.perf_counter()
    for arm in ARMS:
        server(arm == "graph").run(make_requests(
            cfg, 3, 64, 4, groups=sorted(groups), seed=1))
    torch.cuda.synchronize()
    secs = {"warm_up": time.perf_counter() - t0}

    runs = serve_in_turns(kernels, cfg, server, requests,
                          "decode_attention", "decode_attention_paged",
                          "serve")
    secs["turns"] = time.perf_counter() - t0 - sum(secs.values())
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
        fast = replay_logits(cfg, params, two, pol, GPT2_REPLAY_STEPS)
        ref = replay_logits(cfg, params, two,
                            pol.replace(kernel_backend="reference"),
                            GPT2_REPLAY_STEPS)
        worst[name] = check_replay(name, two, fast, ref)
    res["replay_max_abs_logit_diff"] = worst
    secs["replays"] = time.perf_counter() - t0 - sum(secs.values())

    def short():              # 8 new tokens: gathering the profiler's
        # CPU + CUDA trace takes ~0.4 s a decode step
        return make_requests(cfg, 8, 512, 8, mixed_lengths=True,
                             min_len=32, groups=sorted(groups), seed=2)

    profiles = {arm: profile_serve(kernels, lambda a=arm: server(a == "graph"),
                                   short(), f"serve ({arm} arm)")
                for arm in ARMS}
    res["profile"] = profiles["graph"]
    secs["profiles"] = time.perf_counter() - t0 - sum(secs.values())
    audits = capture_audits(cfg, server, lambda: make_requests(
        cfg, 6, 64, 8, groups=sorted(groups), seed=3), "serve")
    secs["audit"] = time.perf_counter() - t0 - sum(secs.values())
    res["phase_seconds"] = secs
    emit(res)
    arm_summary(runs, profiles, audits, compare, "serve")
    return {"serve": counts, "serve_eager": runs["eager"][0]["counts"]}, reqs


def phase_serve_paged(kernels, smi, cfg, params, policy, groups):
    """Full-width gpt2-small through Server(paged=True): max_batch 8,
    max_seq 1024, page 64, 32 requests on one shared 256-token prefix
    plus a suffix of [32, 256] tokens (seed 0), 64 new tokens each, the
    same three policy groups, with graphs and eagerly in turns. Each
    group's first wave is cold and publishes the prefix; its later waves
    attach it and prefill only the suffixes (FA at q_offset=256). The
    cold requests' tokens equal a contiguous serve's at ``block_s`` 64
    (path serve_paged_block64) request by request; each hot request is
    held to its cold solo serve up to a near tie. Returns ({path: launch
    counts}, the first graph turn's requests)."""
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

    t0 = time.perf_counter()
    runs = serve_in_turns(kernels, cfg, server,
                          lambda: paged_requests(cfg, groups),
                          "decode_attention_paged", "decode_attention",
                          "serve_paged", after=hot_and_clean)
    secs = {"turns": time.perf_counter() - t0}
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
        fast = replay_logits_paged(cfg, params, two, pol, shared, PAGE,
                                   GPT2_REPLAY_STEPS)
        ref = replay_logits_paged(cfg, params, two,
                                  pol.replace(kernel_backend="reference"),
                                  shared, PAGE, GPT2_REPLAY_STEPS)
        worst[name] = check_replay(f"paged {name}", two, fast, ref)
    res["replay_max_abs_logit_diff"] = worst
    secs["replays"] = time.perf_counter() - t0 - sum(secs.values())

    # the same requests on the contiguous pool, every group's update block
    # at the page (B2 on every step, one update per 64 keys: the function
    # B7 computes through 64-key pages), one graph arm. A request the
    # paged serve admitted cold prefills the same tokens in both serves,
    # so its tokens must be equal; a hot one prefilled only its suffix
    # against the cached prefix pages (held below to its cold solo serve)
    blk = {n: p.replace(block_s=PAGE) for n, p in groups.items()}
    ring = serve_turn(
        kernels, cfg, lambda cg=True: Server(
            cfg, params, max_batch=8, max_seq=1024,
            policy=policy.replace(block_s=PAGE), policy_groups=blk,
            device="cuda", cuda_graphs=cg),
        lambda: paged_requests(cfg, groups), "graph", "decode_attention",
        "decode_attention_paged", "serve_paged_block64")
    cold = [(r, o) for r, o in zip(reqs, ring["reqs"]) if not r.prefix_hit]
    if not cold:
        fail("serve_paged: no request was admitted cold")
    for r, o in cold:
        if list(r.out) != list(o.out):
            i = next((i for i, (a, b) in enumerate(zip(r.out, o.out))
                      if a != b), min(len(r.out), len(o.out)))
            fail(f"serve_paged: cold request {r.rid} ({r.group}) leaves the "
                 f"block-64 contiguous serve's tokens at step {i}")
    res["block64_contiguous"] = ring["readings"]
    res["vs_block64_contiguous"] = {
        "identical_cold_requests": len(cold),
        "hot_requests_not_compared": len(reqs) - len(cold)}
    secs["block64"] = time.perf_counter() - t0 - sum(secs.values())

    # every hot request against the same request served cold and alone
    solos = []
    for r in hot_reqs:
        solo = Request(r.rid, r.prompt.copy(), max_new)
        server(True, groups[r.group], None).run([solo])
        solos.append(solo.out)
    res["hot_equals_cold_solo"] = near_tie_compare(
        cfg, params, groups, hot_reqs, solos, "hot request",
        "its cold solo tokens")
    secs["hot_solos"] = time.perf_counter() - t0 - sum(secs.values())

    def short():              # 8 new tokens, as serve's profile window
        return make_requests(cfg, 8, suffix, 8, mixed_lengths=True,
                             min_len=32, groups=sorted(groups), seed=2,
                             shared_prefix=shared)

    profiles = {arm: profile_serve(kernels, lambda a=arm: server(a == "graph"),
                                   short(), f"serve_paged ({arm} arm)")
                for arm in ARMS}
    res["profile"] = profiles["graph"]
    secs["profiles"] = time.perf_counter() - t0 - sum(secs.values())
    audits = capture_audits(cfg, server, lambda: make_requests(
        cfg, 6, 64, 8, groups=sorted(groups), seed=3, shared_prefix=PAGE),
        "serve_paged")
    secs["audit"] = time.perf_counter() - t0 - sum(secs.values())
    res["phase_seconds"] = secs
    emit(res)
    arm_summary(runs, profiles, audits, compare, "serve_paged")
    return ({"serve_paged": counts,
             "serve_paged_eager": runs["eager"][0]["counts"],
             "serve_paged_block64": ring["counts"]}, reqs)


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
    t0 = time.perf_counter()
    ranks = _spawn_ranks(SHARD_RANKS)
    secs = {"ranks": time.perf_counter() - t0}
    base_reqs = contiguous_sharded_requests(cfg, groups)
    Server(cfg, params, max_batch=8, max_seq=1024, policy=policy,
           policy_groups=groups, device="cuda").run(base_reqs)
    secs["unsharded"] = time.perf_counter() - t0 - sum(secs.values())
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
        secs[path] = time.perf_counter() - t0 - sum(secs.values())
        res["phase_seconds"] = dict(secs)
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


# ------------------------------------------------------ the training path

TRAIN_SHAPE = dict(b=8, s=1024, h=12, hkv=12, d=64)      # gpt2's step
TRAIN_D128 = dict(b=8, s=1024, h=40, hkv=10, d=128)      # phi3's G 4
TRAIN_BLOCK_K = 512                 # gpt2's attn_block_k, the policy's
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_STEPS = 40                    # the loss-falls run, every step logged
TRAIN_LOG_EVERY = 5                 # the losses the fall is read on: 8,
                                    # the first four apart from the last
# The loss falls: the mean of the last four of the every-5th-step losses
# below the first four's, and that fall larger by TRAIN_FALL_MIN nats
# than the same fall of the initial weights' losses on the same batches
# (the lr-0 control, which must fail this check). A batch's own loss
# spreads by ~0.05 nats (its 128 motif tokens' initial logits), which
# the paired difference cancels.
TRAIN_FALL_MIN = 0.05
TRAIN_RESUME_K = 3                  # k: steps k..2k-1 resumed from k
# warmup and the cosine over the run: at lr 1e-3 held flat (the head of
# a 1,000-step schedule) the loss rose past the control's from step 30
# on an H100 (11.17 against 10.98)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=3, total_steps=TRAIN_STEPS)
TRAIN_TIMED_STEPS = 5
# one step on the cuda tier against one on the reference tier, same
# weights and batch: the only difference is B3's forward (its order
# flips a few bf16 outputs, ATT_LIMITS); B1 under vexp is bitwise. The
# loss, the global gradient norm and every gradient leaf (max |d| over
# the leaf's max |g|) within these shares; a new parameter within 2 lr
# of the other tier's: Adam's first step is lr x a gradient's sign, so
# an element whose gradient is small against the tiers' difference
# flips (an H100 read 2.2 % of the elements apart by more than 1e-3 lr;
# reported, not held). A flipped bf16 activation moves a gradient
# element by up to a bf16 ulp of it (0.4-0.8 %): the leaves read 7.7e-3
# on an H100 80GB HBM3 at 700 W.
TIER_LOSS_REL, TIER_GNORM_REL, TIER_GRAD_REL = 1e-4, 1e-3, 2e-2
# B1 under exact is within 2 f32 ulps of torch.exp (the vexp phase), so
# its gradient g * y within 3 of the plain one's
B1_EXACT_GRAD_ULP = 3


def _grads_equal(a, b):
    return all(bool(nan_aware_equal(x, y).all()) for x, y in zip(a, b))


def _fa_train_case(policy_cls, shape, seed):
    """B3's autograd Function (forward: the kernel; backward: the
    recompute of attention_flash) against autograd of attention_flash on
    the same inputs and one cotangent, per exp backend: dq, dk, dv bit
    for bit, dq and dk 0 under vexp_hw, the forward inside ATT_LIMITS
    of the plain version. Returns (readings, {exp: ms of the Function's
    forward + backward}, {exp: the plain's})."""
    from repro_torch.core.attention import attention_flash
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, s, h, hkv, d = (shape[k] for k in ("b", "s", "h", "hkv", "d"))
    q = torch.randn(b, s, h, d, generator=g, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    cot = torch.randn(b, s, h, d, generator=g, device="cuda").to(
        torch.bfloat16)
    readings, ms, plain_ms = {}, {}, {}
    for exp in EXP_BACKENDS:
        pol = policy_cls(exp_backend=exp, block_k=TRAIN_BLOCK_K)

        def kernel_vjp():
            qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
            out = fa.flash_attention(qa, ka, va, causal=True, policy=pol)
            return out, torch.autograd.grad(out, (qa, ka, va), cot)

        def plain_vjp():
            qb, kb, vb = (t.detach().requires_grad_() for t in (q, k, v))
            ref = attention_flash(qb, kb, vb, causal=True, exp_impl=exp)
            return ref, torch.autograd.grad(ref, (qb, kb, vb), cot)

        out, ga = kernel_vjp()
        _, gb = plain_vjp()
        if not _grads_equal(ga, gb):
            fail(f"train FA d={d} {exp}: dq / dk / dv through the kernel's "
                 f"Function differ from autograd of attention_flash")
        if exp == "vexp_hw" and (ga[0].any() or ga[1].any()):
            fail(f"train FA d={d} vexp_hw: dq / dk not 0")
        if exp != "vexp_hw" and not (ga[0].any() and ga[1].any()):
            fail(f"train FA d={d} {exp}: dq / dk all 0")
        plain = fa.flash_attention_plain(q, k, v, causal=True,
                                         block_k=TRAIN_BLOCK_K,
                                         exp_backend=exp)
        readings[(exp, "kernel")] = kernel_vs_plain(out.detach(), plain)
        del out, ga, gb, plain
        ms[exp] = cuda_time_ms(kernel_vjp, iters=3, warmup=1)
        plain_ms[exp] = cuda_time_ms(plain_vjp, iters=3, warmup=1)
    return readings, ms, plain_ms


def _vexp_train_case(policy_cls):
    """B1's autograd Function against autograd of the plain exp at the
    loss's chunk shape (B, 512, vocab padded) of score offsets <= 0 with
    saturating tails, per exp backend: the values and the gradients bit
    for bit (exact: within B1_EXACT_GRAD_ULP), 0 under vexp_hw."""
    from repro_torch.kernels import vexp as kv
    g = torch.Generator(device="cuda").manual_seed(22)
    x = -(torch.randn(TRAIN_BATCH, 512, 50304, generator=g,
                      device="cuda").abs() * 8)
    x[0, 0, :4] = torch.tensor([-200.0, -100.0, -87.0, 0.0])
    cot = torch.randn(x.shape, generator=g, device="cuda")
    out = {}
    for exp in EXP_BACKENDS:
        pol = policy_cls(exp_backend=exp)
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        ya = kv.vexp(xa, policy=pol)
        (ga,) = torch.autograd.grad(ya, xa, cot)
        yb = kv.vexp_plain(xb, exp)
        (gb,) = torch.autograd.grad(yb, xb, cot)
        if exp == "exact":
            ulp = int(f32_ulp_distance(ga.abs(), gb.abs()).max())
            if ulp > B1_EXACT_GRAD_ULP:
                fail(f"train B1 exact: gradient {ulp} ulps off the plain "
                     f"one's (limit {B1_EXACT_GRAD_ULP})")
            out[f"{exp}_grad_max_ulp"] = ulp
        elif not (bool(nan_aware_equal(ya, yb).all())
                  and bool(nan_aware_equal(ga, gb).all())):
            fail(f"train B1 {exp}: the Function's value or gradient "
                 f"differs from the plain function's")
        if exp == "vexp_hw" and ga.any():
            fail("train B1 vexp_hw: gradient not 0")
        del xa, xb, ya, yb, ga, gb
    return out


def phase_train_kernels(policy_cls):
    """The training path's kernels under autograd: B3 at gpt2's step
    shape (B 8, S 1,024, 12 heads of 64) and at D 128, G 4 (phi3's 40 on
    10), B1 at the loss's chunk shape."""
    res, fa_rows = {}, {}
    for label, shape, seed in (("d64", TRAIN_SHAPE, 21),
                               ("d128g4", TRAIN_D128, 23)):
        readings, ms, plain_ms = _fa_train_case(policy_cls, shape, seed)
        check_attention("flash_attention", readings, f" train {label}")
        fa_rows[label] = {
            "fwd_max_abs_err": max(r[0] for r in readings.values()),
            "fwd_mismatch_share": max(r[1] for r in readings.values()),
            "fwd_max_abs_err_beyond_one_ulp": max(
                r[2] for r in readings.values()),
            "fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain_ms}
        torch.cuda.empty_cache()
    b1 = _vexp_train_case(policy_cls)
    torch.cuda.empty_cache()
    res = {"flash_attention": fa_rows, "vexp": b1}
    emit({"phase": "train_kernels", "block_k": TRAIN_BLOCK_K, **res})
    return res


def _train_batch(cfg, step):
    """The trainer's batch of ``step`` (StructuredLM, seed 17), on the
    card."""
    from repro_torch.data import StructuredLM
    hb = StructuredLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=17).batch(step)
    return {k: torch.from_numpy(v).cuda() for k, v in hb.items()}


def _step_readings(cfg, step_fn, params, state):
    """Device ms of TRAIN_TIMED_STEPS steps by CUDA events (the median),
    peak memory over them, and the device busy share of one more step
    (torch.profiler, CUDA kernel time over the step's wall time)."""
    from torch.profiler import ProfilerActivity, profile
    batches = [_train_batch(cfg, i) for i in range(TRAIN_TIMED_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for bt in batches[:-1]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, _ = step_fn(params, state, bt)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step_fn(params, state, batches[-1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, n_kernels, by_name = 0.0, 0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            n_kernels += 1
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ms = sorted(times)[len(times) // 2]
    return {"step_ms": ms, "step_ms_all": times,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
            "peak_bytes": peak,
            "device_busy_share": (busy / wall_us if n_kernels
                                  else "not measured"),
            "kernels_a_step": n_kernels, "step_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "top_kernels_ms": {k: v / 1e3 for k, v in top}}


def train_step_bound_ms(cfg):
    """(The least ms of one step, the ms of the design's recomputes.) The
    bound: the step's operations over the peak rate of their type (the
    bytes, ~3.5 GB of masters, moments and gradients plus activations,
    take ~2 ms at 3.35 TB/s, below it), three passes of each product: the
    forward and the two backward products. bf16: the layers' products, 6
    x their weights x the tokens. f32 (the reference's f32 attention and
    logits): causal attention's two products, the lower half of the
    scores, 2 B H S^2 D a layer a pass; the logits product, 2 T D V a
    pass. The recomputes (attention_flash's forward in B3's backward,
    each loss chunk's forward again in its backward) are one more pass
    of each, reported beside the bound, not in it."""
    t = TRAIN_BATCH * TRAIN_SEQ
    d, f, layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    w_layer = 4 * d * d + 2 * d * f
    bf16 = 6 * w_layer * layers * t
    att = 2 * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ ** 2 * cfg.hd * layers
    logits = 2 * t * d * cfg.vocab_padded
    return ((bf16 / BF16_FLOP_PER_S + 3 * (att + logits) / F32_FLOP_PER_S)
            * 1e3, (att + logits) / F32_FLOP_PER_S * 1e3)


def loss_fell(losses, control):
    """The loss-falls check (TRAIN_FALL_MIN) on the every-5th-step
    losses of a run and the initial weights' losses on the same batches:
    (passed, the run's fall, the control's fall)."""
    def fall(ls):
        return float(np.mean(ls[:4]) - np.mean(ls[-4:]))
    if len(losses) < 8:
        fail(f"train: {len(losses)} losses; the fall needs 8")
    ran, ctrl = fall(losses), fall(control)
    return ran > 0 and ran - ctrl > TRAIN_FALL_MIN, ran, ctrl


def _control_losses(cfg, policy, steps):
    """The lr-0 control: the initial weights' (``train``'s seed 0) loss
    on each of ``steps``' batches, forwards only."""
    from repro_torch.models import api
    params = api.init_params(cfg, 0, device="cuda", trainable=True)
    with torch.no_grad():
        out = [float(api.loss_fn(params, cfg, _train_batch(cfg, s),
                                 policy=policy, device="cuda"))
               for s in steps]
    del params
    return out


def _tier_step(cfg, opt_cfg, base):
    """One step on the cuda and on the reference tier from the same
    weights and batch: (loss, gradient norm, lr, new parameters,
    gradients) each; the gradients from ``value_and_grad`` on the same
    inputs."""
    from repro_torch import optim
    from repro_torch.launch import train as ltrain
    from repro_torch.models import api
    out = {}
    for tier in ("cuda", "reference"):
        pol = base.replace(kernel_backend=tier)
        params = api.init_params(cfg, 0, device="cuda", trainable=True)
        _, grads = ltrain.value_and_grad(params, cfg, _train_batch(cfg, 0),
                                         pol)
        state = optim.init(dict(params.named_parameters()), opt_cfg)
        step = ltrain.make_train_step(cfg, opt_cfg, policy=pol)
        params, state, stats = step(params, state, _train_batch(cfg, 0))
        out[tier] = (float(stats["loss"]), float(stats["grad_norm"]),
                     float(stats["lr"]),
                     {n: p.detach() for n, p in params.named_parameters()},
                     grads)
        del params, state
    return out


def _check_tiers(out):
    (lc, gc_, lr, pc, dc), (lr_, gr, _, pr, dr) = (out["cuda"],
                                                   out["reference"])
    worst, moved, total, grad_rel = 0.0, 0, 0, 0.0
    for n in pc:
        dd = (pc[n] - pr[n]).abs()
        worst = max(worst, float(dd.max()))
        moved += int((dd > 1e-3 * lr).sum())
        total += dd.numel()
        grad_rel = max(grad_rel, float((dc[n] - dr[n]).abs().max()
                                       / dr[n].abs().max().clamp(
                                           min=1e-30)))
    res = {"loss_cuda": lc, "loss_reference": lr_,
           "loss_rel": abs(lc - lr_) / abs(lr_), "grad_norm_cuda": gc_,
           "grad_norm_reference": gr, "grad_norm_rel": abs(gc_ - gr) / gr,
           "grad_leaf_rel_max": grad_rel, "new_params_max_abs": worst,
           "lr": lr, "new_params_moved_share": moved / total}
    if res["loss_rel"] > TIER_LOSS_REL or res["grad_norm_rel"] > \
            TIER_GNORM_REL or grad_rel > TIER_GRAD_REL or \
            worst > 2 * lr * (1 + 1e-3):
        fail(f"train tiers: cuda vs reference step off its limits: {res}")
    return res


def _exp_steps(cfg, base):
    """One loss and gradient on the cuda tier under each exp backend from
    the same weights and batch: every wq / wk gradient exactly 0 under
    vexp_hw (the reference's zero derivative), not under the others."""
    from repro_torch.launch import train as ltrain
    from repro_torch.models import api
    params = api.init_params(cfg, 0, device="cuda", trainable=True)
    out = {}
    for exp in EXP_BACKENDS:
        loss, grads = ltrain.value_and_grad(
            params, cfg, _train_batch(cfg, 0), base.replace(exp_backend=exp))
        qk = [g for n, g in grads.items()
              if n.endswith(("attn.wq", "attn.wk"))]
        zero = all(not bool(g.any()) for g in qk)
        if zero != (exp == "vexp_hw"):
            fail(f"train {exp}: wq / wk gradients {'all' if zero else 'not'}"
                 f" 0")
        out[exp] = {"loss": float(loss),
                    "grad_norm": float(torch.sqrt(sum(
                        (g.float() ** 2).sum() for g in grads.values()
                        if g is not None))),
                    "wq_wk_grads_zero": zero}
        del grads
    del params
    return out


def phase_train_gpt2(kernels, smi):
    """Full-width gpt2-small trained through ``repro_torch.launch.train``
    (batch 8, seq 1,024, StructuredLM seed 17, vexp, the cuda tier): the
    loss falls over TRAIN_STEPS (``loss_fell`` against the lr-0 control,
    which must fail it), a run stopped at k and resumed from its
    checkpoint in a fresh ``train`` repeats the losses of steps k..2k-1
    bit for bit, the preemption drain leaves the drained step's
    checkpoint, one step on the cuda tier against the reference tier,
    one loss and gradient under each exp backend, the step's device ms,
    tokens / s, peak memory and busy share; no library attention, B3
    twelve launches a forward (none in the backward), B1 four (two loss
    chunks, each again in the recompute). Returns the path's launch
    counts."""
    import tempfile
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.ft import PreemptionGuard
    from repro_torch.launch import train as ltrain
    from repro_torch.models import api
    from repro_torch.runtime import resolve_policy
    cfg = get_config("gpt2-small")
    base = resolve_policy(cfg, env={})
    if base.kernel_backend != "cuda" or base.block_k != TRAIN_BLOCK_K:
        fail(f"gpt2's train policy is {base.describe()}")
    opt_cfg = optim.OptConfig(**TRAIN_OPT)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_calls = []

    def counting_sdpa(*a, **k):
        sdpa_calls.append(1)
        return sdpa(*a, **k)

    cuda_fwd = {"n": 0}             # cuda-tier forwards and backwards

    def quiet(msg):
        lines.append(msg)

    lines = []
    torch.cuda.synchronize()
    torch.nn.functional.scaled_dot_product_attention = counting_sdpa
    kernels.reset_launch_counts()
    t_path = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, opt_cfg=opt_cfg,
                      policy=base, device="cuda", log=quiet)
            t0 = time.perf_counter()
            _, full = ltrain.train(cfg, steps=TRAIN_STEPS, log_every=1,
                                   guard=PreemptionGuard(signals=()), **kw)
            run_s = time.perf_counter() - t0
            cuda_fwd["n"] += TRAIN_STEPS
            logged = [s for s, _ in full if s % TRAIN_LOG_EVERY == 0]
            fell = [l for s, l in full if s % TRAIN_LOG_EVERY == 0]
            control = _control_losses(cfg, base, logged)
            no_grad_fwd = len(logged)
            ok, ran_fall, ctrl_fall = loss_fell(fell, control)
            if not ok:
                fail(f"train: the loss did not fall: {fell}, the lr-0 "
                     f"control's {control} (falls {ran_fall}, {ctrl_fall})")
            if loss_fell(control, control)[0]:
                fail("train: the lr-0 control passes the loss-falls check")
            if control[0] != fell[0]:       # step 0 runs the initial weights
                fail(f"train: the control's step-0 loss {control[0]} is not "
                     f"the run's {fell[0]}")
            k = TRAIN_RESUME_K
            d = os.path.join(tmp, "resume")
            ltrain.train(cfg, steps=k, ckpt_dir=d, ckpt_every=1000,
                         log_every=1, guard=PreemptionGuard(signals=()),
                         **kw)
            _, resumed = ltrain.train(cfg, steps=2 * k, ckpt_dir=d,
                                      ckpt_every=1000, log_every=1,
                                      guard=PreemptionGuard(signals=()),
                                      **kw)
            cuda_fwd["n"] += 2 * k
            want = [(s, l) for s, l in full if k <= s < 2 * k]
            if f"[train] resumed from step {k}" not in lines or \
                    resumed != want:
                fail(f"train resume: {resumed} != the uninterrupted "
                     f"run's {want}")
            guard = PreemptionGuard(signals=())
            n_log = len(lines)

            def drain_log(msg):
                lines.append(msg)
                if len(lines) == n_log + 2:
                    guard.trigger()

            p_dir = os.path.join(tmp, "preempt")
            _, hist = ltrain.train(cfg, steps=TRAIN_STEPS, ckpt_dir=p_dir,
                                   ckpt_every=1000, log_every=1,
                                   guard=guard, **{**kw, "log": drain_log})
            from repro_torch import ckpt as ckpt_lib
            drained = ckpt_lib.latest_step(p_dir)
            cuda_fwd["n"] += len(hist)
            if len(hist) != 2 or drained != 2:
                fail(f"train preemption: {len(hist)} steps, checkpoint at "
                     f"{drained} (want 2, 2)")
        tiers = _check_tiers(_tier_step(cfg, opt_cfg, base))
        cuda_fwd["n"] += 2
        exps = _exp_steps(cfg, base)
        cuda_fwd["n"] += len(EXP_BACKENDS)
        params = api.init_params(cfg, 0, device="cuda", trainable=True)
        state = optim.init(dict(params.named_parameters()), opt_cfg)
        step_fn = ltrain.make_train_step(cfg, opt_cfg, policy=base)
        before = kernels.launch_counts()
        params, state, _ = step_fn(params, state, _train_batch(cfg, 0))
        torch.cuda.synchronize()
        one = {n: c - before[n] for n, c in kernels.launch_counts().items()}
        readings = _step_readings(cfg, step_fn, params, state)
        cuda_fwd["n"] += 1 + TRAIN_TIMED_STEPS + 1
        del params, state, step_fn
    finally:
        torch.nn.functional.scaled_dot_product_attention = sdpa
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    counts = kernels.launch_counts()
    layers = cfg.n_layers
    chunks = -(-TRAIN_SEQ // cfg.loss_chunk)
    b1 = 2 * chunks                     # a chunk and its recompute
    if sdpa_calls:
        fail(f"train: {len(sdpa_calls)} library attention calls")
    if one["flash_attention"] != layers or one["vexp"] != b1:
        fail(f"train: one step launched {one} (want {layers} B3, {b1} B1)")
    want = {"flash_attention": layers * (cuda_fwd["n"] + no_grad_fwd),
            "vexp": b1 * cuda_fwd["n"] + chunks * no_grad_fwd}
    if any(counts[n] != c for n, c in want.items()) or any(
            c for n, c in counts.items()
            if n not in want and n != "vexp_hw_table"):
        fail(f"train path launched {counts}, want {want} and no other "
             f"kernel")
    bound, recompute_ms = train_step_bound_ms(cfg)
    emit({"phase": "train_gpt2", "arch": cfg.arch_id,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "opt": TRAIN_OPT,
          "policy": base.describe(), "nvidia_smi": smi,
          "losses_every_5": fell, "lr0_control_losses": control,
          "fall": ran_fall, "lr0_control_fall": ctrl_fall,
          "fall_min": TRAIN_FALL_MIN,
          "run_s": run_s, "path_s": path_s, "resume_k": TRAIN_RESUME_K,
          "resumed_losses": resumed, "tiers": tiers, "exps": exps,
          "one_step_launches": one, "cuda_forwards": cuda_fwd["n"],
          "bound_ms": bound, "bound_by": "operations",
          "recompute_ms": recompute_ms, **readings,
          "step_vs_bound": readings["step_ms"] / bound,
          "launches": counts})
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------- the ssm family

SSM_ARCH = "mamba2-1.3b"
# vexp kernel launches a layer: a decode step's gate exps (two SiLUs, the
# softplus, exp(A_log), the decay: models/ssm.py ssm_layer_decode), and a
# prefill wave's or chunk's (those five, the intra-chunk decays, the
# chunk-state decays and the inter-chunk decays: ssm_layer_apply)
SSM_DECODE_EXPS = 5
SSM_PREFILL_EXPS = 8
# The SSD's two forms (teacher-forced decode steps against one forward
# over prompt + tokens), full width: max |decode - forward| <=
# SSM_FORM_LIMIT[exp] x max |logit|. Twice (the ratio
# tests/test_torch_ssm.py allows the port against the JAX package) the
# JAX package's own gap under this check's conditions: mamba2-1.3b's
# widths, SSD block 256, prompts of 300 and 487 tokens (both cross a
# block) and 64 forced steps, read at 8, 16 and 24 layers (0.0143 /
# 0.0230 / 0.0295 of max |logit| under exact) and carried to 48 by the
# power law those readings fit (tools/ssm_form_gap.py --width full
# --layers 8 16 24 --extrapolate 48: 0.0469 / 0.0544 / 0.0587 under
# exact / vexp / vexp_hw). The gap grows with depth as bf16 rounding
# (and under the approximate exps, exp(a) exp(b) != exp(a + b)) moves
# the two forms apart in every layer.
SSM_FORM_LIMIT = {"exact": 0.0938, "vexp": 0.1087, "vexp_hw": 0.1174}
SSM_GATE_SHAPES = {"decode_conv": (8, 1, 4352), "decode_heads": (8, 64),
                   "prefill_decay": (8, 2, 64, 256, 256)}


def ssm_setup():
    """Full-width mamba2-1.3b with random weights from
    ``torch.Generator("cuda").manual_seed(0)``, its default policy (the
    cuda tier) and the three policy groups."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.runtime import parse_policy_groups, resolve_policy
    cfg = get_config(SSM_ARCH)
    params = api.init_params(cfg, 0, device="cuda")
    policy = resolve_policy(cfg, env={})
    if policy.kernel_backend != "cuda":
        fail(f"ssm: default tier is {policy.kernel_backend}, not cuda")
    groups = parse_policy_groups("eval=exact,bulk=vexp,hw=vexp_hw", cfg,
                                 base=policy)
    return cfg, params, policy, groups


def ssm_requests(cfg, groups, n=16, max_new=64, seed=0):
    from repro_torch.launch.serve import make_requests
    return make_requests(cfg, n, 512, max_new, mixed_lengths=True,
                         min_len=32, groups=sorted(groups), seed=seed)


def ssm_server(cfg, params, policy, groups, cuda_graphs=True):
    from repro_torch.launch.serve import Server
    return Server(cfg, params, max_batch=8, max_seq=1024, policy=policy,
                  policy_groups=groups, device="cuda",
                  cuda_graphs=cuda_graphs)


def check_ssm_serve(cfg, st, before, counts, replayed, sdpa_calls, arm,
                    spec_k, what):
    """An ssm serve's launches and graphs. vexp launches = layers x (5 a
    decode step, 5 (k + 2W) a burst of k drafts and a two-scan verify of
    W = k + 1 steps each, 8 a prefill wave or chunk); no other kernel
    (no attention), no SDPA call. Graph arm: every decode step, burst and
    chunk a replay of a graph captured when the group was built (the
    captures of ``before``), replayed vexp launches = all but the waves';
    eager arm: no capture, no replay. Returns (waves, chunks, steps)."""
    n = cfg.n_layers
    waves = sum(s["admit_waves"] for s in st.values())
    chunks = sum(s["prefill_chunks"] for s in st.values())
    steps = sum(s["decode_steps"] for s in st.values())
    per_step = SSM_DECODE_EXPS * ((3 * spec_k + 2) if spec_k else 1)
    want = n * (per_step * steps + SSM_PREFILL_EXPS * (waves + chunks))
    if counts["vexp"] != want:
        fail(f"{what}: vexp launches {counts['vexp']} != {n} layers x "
             f"({per_step} x {steps} steps + {SSM_PREFILL_EXPS} x "
             f"({waves} waves + {chunks} chunks)) = {want}")
    other = {k: v for k, v in counts.items()
             if k not in ("vexp", "vexp_hw_table") and v}
    if other or sdpa_calls:
        fail(f"{what}: launched {other}, {sdpa_calls} SDPA calls")
    want_rep = (n * (per_step * steps + SSM_PREFILL_EXPS * chunks)
                if arm == "graph" else 0)
    if replayed["vexp"] != want_rep:
        fail(f"{what}: {replayed['vexp']} replayed vexp launches != "
             f"{want_rep}")
    for g, s in st.items():
        caps = (s["graph_captures"], s["chunk_graph_captures"],
                s.get("spec_graph_captures", 0))
        reps = (s["graph_replays"], s["chunk_graph_replays"],
                s.get("spec_graph_replays", 0))
        if arm == "eager":
            if any(caps) or any(reps):
                fail(f"{what} group {g} (eager): captures {caps}, replays "
                     f"{reps}")
            continue
        b = before[g]
        built = (b["graph_captures"], b["chunk_graph_captures"],
                 b.get("spec_graph_captures", 0))
        k = spec_k if "spec_k" in s else 0
        want_reps = ((k or 1) * s["decode_steps"], s["prefill_chunks"],
                     s["decode_steps"] if k else 0)
        if s["step_mode"] != "graph" or caps != built or caps[0] < 1 or \
                caps[1] != (1 if s["prefill_chunk"] else 0) or \
                caps[2] != (1 if k else 0) or reps != want_reps:
            fail(f"{what} group {g}: {s['step_mode']}, captures {caps} "
                 f"(built with {built}), replays {reps} (want {want_reps})")
    return waves, chunks, steps


def ssm_serve_once(kernels, cfg, make_server, make_reqs, arm, spec_k, what):
    """One serve with the launch counts set to 0 just before it and read
    just after, checked. Returns the turn: the server, requests, stats,
    counts and readings."""
    srv = make_server(arm == "graph")
    before = srv.stats()
    reqs = make_reqs()
    secs, counts, sdpa_calls, peak, clocks = timed_serve(kernels, srv, reqs)
    replayed = kernels.replay_counts()
    st = srv.stats()
    check_requests(cfg, reqs, reqs[0].max_new)
    waves, chunks, steps = check_ssm_serve(cfg, st, before, counts, replayed,
                                           sdpa_calls, arm, spec_k, what)
    some = next(iter(st.values()))
    readings = {**serve_metrics(reqs, secs),
                "wall_per_decode_step_s": some["wall_per_decode_step_s"],
                "admit_waves": waves, "prefill_chunks": chunks,
                "decode_steps": steps,
                "admit_s_total": sum(s["admit_s_total"] for s in st.values()),
                "capture_s": sum(s["graph_capture_s"]
                                 + s["chunk_graph_capture_s"]
                                 + s.get("spec_graph_capture_s", 0.0)
                                 for s in st.values()),
                "vexp_launches": counts["vexp"],
                "vexp_replayed": replayed["vexp"],
                "peak_memory_bytes": peak, "clocks_power": clocks}
    return {"srv": srv, "reqs": reqs, "stats": st, "counts": counts,
            "readings": readings, "secs": secs, "peak": peak,
            "clocks": clocks}


def ssm_live_server(make_server, reqs):
    """A server of ``make_server`` with ``reqs`` submitted and three ticks
    run: the first wave admitted and decoding."""
    srv = make_server()
    for r in reqs:
        srv.submit(r)
    for _ in range(3):
        srv.step()
    return srv


def ssm_step_readings(srv):
    """Per busy group of ``srv``: the graph ms of one decode step
    replayed back to back on its live pool (CUDA events; the state
    advances, positions do not matter to a recurrence), the vexp
    launches a replay holds, and the device kernels of one step from a
    profile window of one replay (the reference tier's step is ~25,000
    kernels, whose events the profiler takes seconds to gather)."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, g in srv._groups.items():
        if not g.busy:
            continue
        graph = g.state.graph
        ms = cuda_time_ms(graph.graph.replay, iters=10)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        kern = [e for e in dev if "memcpy" not in e.name.lower()
                and "memset" not in e.name.lower()]
        out[name] = {"policy": g.policy.describe(), "graph_ms": ms,
                     "live_slots": int(g.live_dev.sum()),
                     "vexp_launches_per_step": graph.launches.get("vexp", 0),
                     "device_events_per_step": len(dev),
                     "kernels_per_step": len(kern),
                     "device_busy_ms_per_step": sum(
                         e.time_range.elapsed_us() for e in dev) / 1e3}
    torch.cuda.synchronize()
    return out


class GateCheck:
    """While active, every vexp kernel launch (``kernels.vexp.vexp``, as
    the gates reach it through ``exp_callable``) is held against the plain
    version on the same input: bitwise under vexp and vexp_hw, within 2
    ulp under exact (the vexp phase's rule); the worst distance and the
    non-finite mismatches accumulate on the card over every time it is
    active and are read on each exit. Launches made here to check do not
    enter any serve's count."""

    def __init__(self):
        from repro_torch.kernels import vexp as mod
        self.mod, self.calls, self.worst, self.odd = mod, {}, {}, {}
        self.max_ulp = {}

    def __enter__(self):
        self.orig = self.mod.vexp
        self.mod.vexp = self.checked
        return self

    def __exit__(self, *exc):
        self.mod.vexp = self.orig
        if exc[0] is not None:
            return False
        self.max_ulp = {b: int(t) for b, t in self.worst.items()}
        for b, ulp in self.max_ulp.items():
            odd, limit = int(self.odd[b]), (2 if b == "exact" else 0)
            if ulp > limit or odd:
                fail(f"ssm gate exps ({b}): the kernel is {ulp} ulp from "
                     f"the plain version ({odd} non-finite mismatches; "
                     f"limit {limit})")
        return False

    def checked(self, x, *, policy):
        y = self.orig(x, policy=policy)
        ref = self.mod.vexp_plain(x, policy.exp_backend)
        both = torch.isfinite(y) & torch.isfinite(ref)
        ulp = torch.where(both, f32_ulp_distance(y, ref), 0).max()
        odd = (~nan_aware_equal(y, ref) & ~both).sum()
        b = policy.exp_backend
        self.calls[b] = self.calls.get(b, 0) + 1
        self.worst[b] = torch.maximum(self.worst[b], ulp) \
            if b in self.worst else ulp
        self.odd[b] = self.odd[b] + odd if b in self.odd else odd
        return y


def ssm_replay_logits(cfg, params, reqs, policy, steps, gates=None,
                      checked=0):
    """Teacher-forced logits of ``reqs`` under ``policy``: one ragged
    prefill, then one decode step per emitted token (the recurrence).
    Returns ``steps`` (B, V) f32 logits. With ``gates`` (a GateCheck), the
    prefill and the decode steps that give the first ``checked`` logits
    run under it."""
    from repro_torch.models import ssm
    plen = np.array([len(r.prompt) for r in reqs], np.int32)
    toks = np.zeros((len(reqs), int(plen.max())), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :plen[i]] = r.prompt

    def advance(out, state, upto):
        while len(out) < upto:
            t = len(out) - 1
            tok = torch.as_tensor([[r.out[t]] for r in reqs],
                                  dtype=torch.int32, device="cuda")
            logits, state = ssm.decode_step(params, cfg, tok, state, None,
                                            policy=policy)
            out.append(logits[:, 0])
        return state

    with gates if gates is not None else contextlib.nullcontext():
        logits, state = ssm.prefill(
            params, cfg, torch.as_tensor(toks, device="cuda"),
            prompt_len=torch.as_tensor(plen, device="cuda"), policy=policy)
        out = [logits[:, 0]]
        state = advance(out, state, checked)
    advance(out, state, steps)
    return out


def ssm_forward_logits(cfg, params, reqs, policy):
    """The same logits from one ``forward`` (the chunked scan) over each
    request's prompt + its tokens: (steps, B, V)."""
    from repro_torch.models import ssm
    rows = []
    for r in reqs:
        seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
        h = ssm.forward(params, cfg, torch.as_tensor(seq[None],
                                                     device="cuda"),
                        policy=policy)
        rows.append(ssm._logits(params, cfg, h)[0, len(r.prompt) - 1:])
    return torch.stack(rows, dim=1)


SSM_TIER_STEPS = 16            # tokens of the tier check
SSM_GATE_SERVE_NEW = 4         # new tokens of the gate-checked serve


def ssm_gate_serve(cfg, params, policy, groups, gates):
    """The serve's own gate shapes held to their plain versions: one
    eager serve at max_batch 8 of the serve_ssm requests, cut to
    SSM_GATE_SERVE_NEW new tokens (admission waves bucketed as the
    serve's, decode steps over the pool of 8), every vexp launch under
    ``gates``. Returns the gate exps checked, per backend."""
    reqs = ssm_requests(cfg, groups, max_new=SSM_GATE_SERVE_NEW)
    srv = ssm_server(cfg, params, policy, groups, cuda_graphs=False)
    with gates:
        srv.run(reqs)
    check_requests(cfg, reqs, SSM_GATE_SERVE_NEW)
    return dict(gates.calls)


def ssm_replays(cfg, params, groups, reqs, gates):
    """For 2 served requests per group, one teacher-forced replay on the
    cuda tier over all their tokens, whose prefill and first
    SSM_TIER_STEPS steps run under ``gates`` (every gate exp held to its
    plain version): its first SSM_TIER_STEPS logits against the reference
    tier's (check_replay, limit REPLAY_LOGIT_TOL), and all of them
    against one forward over the same tokens (the SSD's two forms, limit
    SSM_FORM_LIMIT x max |logit|)."""
    tiers, forms = {}, {}
    for name, pol in groups.items():
        two = [r for r in reqs if r.group == name][:2]
        dec = ssm_replay_logits(cfg, params, two, pol, len(two[0].out),
                                gates, SSM_TIER_STEPS)
        ref = ssm_replay_logits(cfg, params, two,
                                pol.replace(kernel_backend="reference"),
                                SSM_TIER_STEPS)
        tiers[name] = check_replay(f"ssm {name}", two,
                                   dec[:SSM_TIER_STEPS], ref)
        dec = torch.stack(dec)
        full = ssm_forward_logits(cfg, params, two, pol)
        gap = float((dec - full).abs().max())
        top = float(full[..., :cfg.vocab].abs().max())
        limit = SSM_FORM_LIMIT[pol.exp_backend]
        if not bool(torch.isfinite(full).all()) or gap > limit * top:
            fail(f"ssm {name}: decode vs forward logits differ by {gap} "
                 f"(limit {limit} x max |logit| {top})")
        forms[name] = {"max_abs_gap": gap, "max_abs_logit": top,
                       "relative": gap / top}
    return {"tier_max_abs_logit_diff": tiers, "forms": forms}


def ssm_gate_timing(policy):
    """The vexp kernel at the gate shapes of the SSM path, per backend
    (f32): graph ms beside torch.exp's and the plain version's, and the
    byte bound (8 bytes an element)."""
    from repro_torch.kernels.vexp import vexp, vexp_plain
    out = {}
    for label, shape in SSM_GATE_SHAPES.items():
        x = -torch.rand(shape, device="cuda") * 8
        nbytes = 8 * x.numel()
        b_ms, b_by = bound_ms(nbytes, 0, F32_FLOP_PER_S)
        row = {"shape": list(shape), "bound_ms": b_ms, "bound_by": b_by,
               "library_graph_ms": graph_ms(lambda: torch.exp(x),
                                            f"torch.exp {label}")}
        for exp in EXP_BACKENDS:
            pol = policy.replace(exp_backend=exp)
            row[exp] = {"graph_ms": graph_ms(lambda: vexp(x, policy=pol),
                                             f"vexp {exp} {label}"),
                        "plain_graph_ms": graph_ms(
                            lambda: vexp_plain(x, exp), f"plain {label}")}
        out[label] = row
    return out


def phase_serve_ssm(kernels, smi, cfg, params, policy, groups):
    """Full-width mamba2-1.3b through the port's Server: max_batch 8,
    max_seq 1,024, 16 requests with prompts in [32, 512] (seed 0), 64 new
    tokens, groups eval=exact, bulk=vexp, hw=vexp_hw; the graph and eager
    arms in turns (ARM_TURNS of graph, eager), then the capture audit,
    the decode step's graph ms per group on the cuda and the reference
    tier with its kernels from a profile window, the gate exps against
    their plain versions (over a short eager serve at the serve's shapes
    and the replays), the replays (cuda tier against reference tier, the
    two SSD forms) and the vexp kernel at the gate shapes. Returns
    ({path: launch counts}, the first graph turn's requests)."""
    from repro_torch.analysis import graph_audit

    def server(cuda_graphs=True, grp=groups):
        return ssm_server(cfg, params, policy, grp, cuda_graphs)

    t0 = time.perf_counter()
    for arm in ARMS:                     # warm-up, not measured
        server(arm == "graph").run(ssm_requests(cfg, groups, 3, 4, seed=1))
    torch.cuda.synchronize()
    secs = {"warm_up": time.perf_counter() - t0}
    runs = {arm: [] for arm in ARMS}
    for _ in range(ARM_TURNS):
        for arm in ARMS:
            turn = ssm_serve_once(kernels, cfg, server,
                                  lambda: ssm_requests(cfg, groups), arm, 0,
                                  f"serve_ssm ({arm} arm)")
            del turn["srv"]     # its pools would count in the next peak
            runs[arm].append(turn)
    compare = compare_arms(runs, "serve_ssm")
    first = runs["graph"][0]
    reqs = first["reqs"]
    secs["turns"] = time.perf_counter() - t0 - sum(secs.values())

    # the capture audit, then the decode step's graph ms on the cuda tier
    # from the same server, and on the reference tier
    live = ssm_requests(cfg, groups, max_new=8, seed=3)
    srv = ssm_live_server(server, live)
    audits = {}
    for name, g in srv._groups.items():
        if g.busy:
            try:
                audits[name] = graph_audit.capture_audit(g.state, g.last,
                                                         g.live_dev)
            except graph_audit.AuditError as e:
                fail(f"serve_ssm capture audit, group {name}: {e}")
    secs["capture_audit"] = time.perf_counter() - t0 - sum(secs.values())
    steps = {"cuda": ssm_step_readings(srv)}
    del srv
    ref_groups = {n: p.replace(kernel_backend="reference")
                  for n, p in groups.items()}
    steps["reference"] = ssm_step_readings(ssm_live_server(
        lambda: server(grp=ref_groups),
        ssm_requests(cfg, groups, max_new=8, seed=3)))
    secs["step_graph"] = time.perf_counter() - t0 - sum(secs.values())
    for name, row in steps["cuda"].items():
        want = cfg.n_layers * SSM_DECODE_EXPS
        if row["vexp_launches_per_step"] != want:
            fail(f"serve_ssm group {name}: {row['vexp_launches_per_step']} "
                 f"vexp launches a step, want {want}")
    gates = GateCheck()
    checked = {"serve": ssm_gate_serve(cfg, params, policy, groups, gates)}
    secs["gate_serve"] = time.perf_counter() - t0 - sum(secs.values())
    replays = ssm_replays(cfg, params, groups, reqs, gates)
    checked["serve_and_replays"] = dict(gates.calls)
    secs["replays"] = time.perf_counter() - t0 - sum(secs.values())
    timing = ssm_gate_timing(policy)
    secs["gate_shapes"] = time.perf_counter() - t0 - sum(secs.values())
    emit({"phase": "serve_ssm", "arch": cfg.arch_id,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "d_inner": cfg.d_inner, "ssm_heads": cfg.ssm_nheads,
          "ssm_state": cfg.ssm_state, "ssm_chunk": cfg.ssm_chunk,
          "vocab_padded": cfg.vocab_padded, "arm": "graph",
          **first["readings"], "launches": first["counts"],
          "prompt_lens": [len(r.prompt) for r in reqs],
          "turns": {arm: [t["readings"] for t in runs[arm]] for arm in ARMS},
          "graph_vs_eager_tokens": compare, "capture_audit": audits,
          "step_graph": steps, **replays, "gate_exps_checked": checked,
          "gate_exp_max_ulp": gates.max_ulp, "gate_shapes": timing,
          "phase_seconds": secs, "nvidia_smi": smi})
    return ({"serve_ssm": first["counts"],
             "serve_ssm_eager": runs["eager"][0]["counts"]}, reqs)


def phase_serve_ssm_chunked(kernels, smi, cfg, params, policy, groups,
                            mono):
    """The serve_ssm requests with chunked prefill (chunk 256, one SSD
    block), graph arm: each group's chunk program a second graph built
    with the group, every chunk a replay; tokens equal the monolithic
    serve's (``mono``) up to a near tie."""
    pol, grp = chunked_groups(policy, groups, 256)

    def server(cuda_graphs=True):
        return ssm_server(cfg, params, pol, grp, cuda_graphs)

    turn = ssm_serve_once(kernels, cfg, server,
                          lambda: ssm_requests(cfg, groups), "graph", 0,
                          "serve_ssm_chunked")
    vs = near_tie_compare(cfg, params, groups, turn["reqs"],
                          [r.out for r in mono], "chunked ssm request",
                          "the monolithic serve's tokens")
    emit({"phase": "serve_ssm_chunked", "chunk": 256, **turn["readings"],
          "launches": turn["counts"], "vs_monolithic": vs,
          "nvidia_smi": smi})
    return {"serve_ssm_chunked": turn["counts"]}


def phase_serve_ssm_spec(kernels, smi, cfg, params, policy, groups, mono):
    """The serve_ssm requests under self-speculative decode (spec_k 4,
    drafts under vexp_hw, the "recurrent" scan verify), graph arm: every
    burst k draft replays and one verify replay; tokens equal the plain
    serve's (``mono``) request by request; the hw group's own-backend
    drafts all accepted; graph ms of a draft step, a verify and a plain
    step."""
    grp = spec_policy_groups(groups, "scan")

    def server(cuda_graphs=True):
        return ssm_server(cfg, params, policy, grp, cuda_graphs)

    server().run(ssm_requests(cfg, groups, 3, 8, seed=1))    # warm-up
    torch.cuda.synchronize()
    turn = ssm_serve_once(kernels, cfg, server,
                          lambda: ssm_requests(cfg, groups), "graph",
                          SPEC_K, "serve_ssm_spec")
    for r, want in zip(turn["reqs"], mono):
        if list(r.out) != list(want.out):
            i = next((i for i, (a, b) in enumerate(zip(r.out, want.out))
                      if a != b), min(len(r.out), len(want.out)))
            fail(f"serve_ssm_spec: request {r.rid} ({r.group}) leaves the "
                 f"plain serve's tokens at step {i}")
    control = check_own_draft_control(cfg, turn["stats"], turn["reqs"], "hw",
                                      "scan", "serve_ssm_spec")
    emit({"phase": "serve_ssm_spec", "spec_k": SPEC_K, "draft": "vexp_hw",
          "verify": "recurrent scan",
          **spec_readings(turn["reqs"], turn["stats"], turn["secs"],
                          turn["peak"], turn["clocks"]),
          "serve": turn["readings"], "launches": turn["counts"],
          "spec_equals_plain": {"requests": len(mono), "identical": True},
          "own_draft_control": control,
          "graph_ms_eval": spec_graph_ms(lambda: turn["srv"],
                                         ssm_requests(cfg, groups)[:8],
                                         "eval"),
          "nvidia_smi": smi})
    return {"serve_ssm_spec": turn["counts"]}


# --------------------------------------------------------------- hybrid

HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_PAGE = 64                 # 32 ring pages a slot at window 2048
HYBRID_CHUNK = 256
# vexp launches a recurrent layer (models/hybrid.py): a decode step's
# r, i, a and exp(2 log a) (gate_exps_per_step); a prefill wave's r, i,
# exp(2 log a) and its scan's combines at the wave's width; a chunk's
# those at the chunk's width and the carried state's decay
# (gate_exps_per_pass)
# The hybrid's two forms (teacher-forced decode steps, ring wrapped,
# against one forward over prompt + tokens: the associative scan and the
# windowed FlashAttention), full width: max |decode - forward| <=
# HYBRID_FORM_LIMIT[exp] x max |logit|. Twice the JAX package's own gap
# under this check's conditions: recurrentgemma's widths, window 2048,
# prompts of 300 and 2000 tokens prefilled at the window's width (the
# second's decode wraps the ring), 64 forced steps, read at 5, 8, 14 and
# 20 layers (one, two, four and six periods and the two tail layers:
# 0.00837 / 0.00979 / 0.01013, 0.01016 / 0.01138 / 0.01227, 0.01204 /
# 0.01254 / 0.01320 and 0.01218 / 0.01292 / 0.01317 of max |logit| under
# exact / vexp / vexp_hw) and carried to 38 by the power law the four
# readings fit (tools/ssm_form_gap.py --arch recurrentgemma-9b --width
# full --layers 20 --prior <the 5 / 8 / 14 lines> --extrapolate 38:
# powers 0.28 / 0.20 / 0.19, 0.01521 / 0.01503 / 0.01545 at 38).
HYBRID_FORM_LIMIT = {"exact": 0.0304, "vexp": 0.0301, "vexp_hw": 0.0309}
HYBRID_GATE_SERVE_NEW = 4


def hybrid_setup():
    """Full-width recurrentgemma-9b with random weights from
    ``torch.Generator("cuda").manual_seed(0)``, its default policy (the
    cuda tier) and the three policy groups."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.runtime import parse_policy_groups, resolve_policy
    cfg = get_config(HYBRID_ARCH)
    params = api.init_params(cfg, 0, device="cuda")
    policy = resolve_policy(cfg, env={})
    if policy.kernel_backend != "cuda":
        fail(f"hybrid: default tier is {policy.kernel_backend}, not cuda")
    groups = parse_policy_groups("eval=exact,bulk=vexp,hw=vexp_hw", cfg,
                                 base=policy)
    return cfg, params, policy, groups


def hybrid_requests(cfg, groups, n=16, max_new=64, seed=0):
    """``n`` requests with prompts in [32, 2000] from ``seed``, the first
    four (one or two a group) in [1990, 2040], whose decode wraps the
    2048-slot ring; groups round-robin."""
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(seed)
    names = sorted(groups)
    lens = rng.integers(32, 2001, n)
    lens[:min(4, n)] = rng.integers(1990, 2041, min(4, n))
    return [Request(i, rng.integers(0, cfg.vocab, (int(m),),
                                    dtype=np.int32), max_new,
                    group=names[i % len(names)])
            for i, m in enumerate(lens)]


def hybrid_server(cfg, params, policy, groups, cuda_graphs=True,
                  paged=False):
    """max_batch 8, max_seq 4096: the cache is the 2048-token window, a
    full-window ring that decodes without bound."""
    from repro_torch.launch.serve import Server
    return Server(cfg, params, max_batch=8, max_seq=4096, policy=policy,
                  policy_groups=groups, device="cuda",
                  cuda_graphs=cuda_graphs, paged=paged)


def check_hybrid_serve(cfg, st, before, counts, replayed, sdpa_calls, arm,
                       spec_k, decode, what):
    """A hybrid serve's launches and graphs. Per decode step (a burst of
    k drafts and a two-scan verify of W = k + 1 steps counts k + 2W
    steps): vexp = 4 a recurrent layer, ``decode`` (the contiguous or
    paged flash-decode) one an attention layer; per prefill wave at the
    window's width and per chunk at its width: FA one an attention layer,
    vexp the gates and the scan's combines (``hybrid.gate_exps_per_pass``);
    no other kernel, no SDPA call. Graph arm: every decode step, burst and
    chunk a replay of a graph captured when the group was built, the
    replayed launches all but the waves'; eager arm: no capture, no
    replay. Returns (waves, chunks, steps)."""
    from repro_torch.models import hybrid
    _, n_per, _ = hybrid.period_counts(cfg)
    waves = sum(s["admit_waves"] for s in st.values())
    chunks = sum(s["prefill_chunks"] for s in st.values())
    steps = sum(s["decode_steps"] for s in st.values())
    width = {s["prefill_chunk"] for s in st.values() if s["prefill_chunk"]}
    per_step = (3 * spec_k + 2) if spec_k else 1
    wave_exps = hybrid.gate_exps_per_pass(cfg, cfg.sliding_window)
    chunk_exps = (hybrid.gate_exps_per_pass(cfg, width.pop(), chunk=True)
                  if chunks else 0)
    step_exps = hybrid.gate_exps_per_step(cfg) * per_step * steps
    want = {"vexp": step_exps + wave_exps * waves + chunk_exps * chunks,
            decode: n_per * per_step * steps,
            "flash_attention": n_per * (waves + chunks)}
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"{what}: launches {got} != {want} ({waves} waves, {chunks} "
             f"chunks, {steps} steps)")
    other = {k: v for k, v in counts.items()
             if k not in (*want, "vexp_hw_table") and v}
    if other or sdpa_calls:
        fail(f"{what}: launched {other}, {sdpa_calls} SDPA calls")
    want_rep = ({"vexp": step_exps + chunk_exps * chunks,
                 decode: want[decode], "flash_attention": n_per * chunks}
                if arm == "graph" else dict.fromkeys(want, 0))
    if {k: replayed[k] for k in want} != want_rep:
        fail(f"{what}: replayed {({k: replayed[k] for k in want})} != "
             f"{want_rep}")
    for g, s in st.items():
        caps = (s["graph_captures"], s["chunk_graph_captures"],
                s.get("spec_graph_captures", 0))
        reps = (s["graph_replays"], s["chunk_graph_replays"],
                s.get("spec_graph_replays", 0))
        if arm == "eager":
            if any(caps) or any(reps):
                fail(f"{what} group {g} (eager): captures {caps}, replays "
                     f"{reps}")
            continue
        b = before[g]
        built = (b["graph_captures"], b["chunk_graph_captures"],
                 b.get("spec_graph_captures", 0))
        k = spec_k if "spec_k" in s else 0
        want_reps = ((k or 1) * s["decode_steps"], s["prefill_chunks"],
                     s["decode_steps"] if k else 0)
        if s["step_mode"] != "graph" or caps != built or caps[0] < 1 or \
                caps[1] != (1 if s["prefill_chunk"] else 0) or \
                caps[2] != (1 if k else 0) or reps != want_reps:
            fail(f"{what} group {g}: {s['step_mode']}, captures {caps} "
                 f"(built with {built}), replays {reps} (want {want_reps})")
    return waves, chunks, steps


def hybrid_serve_once(kernels, cfg, make_server, make_reqs, arm, spec_k,
                      decode, what):
    """One serve with the launch counts set to 0 just before it and read
    just after, checked. Returns the turn."""
    srv = make_server(arm == "graph")
    before = srv.stats()
    reqs = make_reqs()
    secs, counts, sdpa_calls, peak, clocks = timed_serve(kernels, srv, reqs)
    replayed = kernels.replay_counts()
    st = srv.stats()
    check_requests(cfg, reqs, reqs[0].max_new)
    waves, chunks, steps = check_hybrid_serve(
        cfg, st, before, counts, replayed, sdpa_calls, arm, spec_k, decode,
        what)
    some = next(iter(st.values()))
    readings = {**serve_metrics(reqs, secs),
                "wall_per_decode_step_s": some["wall_per_decode_step_s"],
                "admit_waves": waves, "prefill_chunks": chunks,
                "decode_steps": steps,
                "admit_s_total": sum(s["admit_s_total"] for s in st.values()),
                "capture_s": sum(s["graph_capture_s"]
                                 + s["chunk_graph_capture_s"]
                                 + s.get("spec_graph_capture_s", 0.0)
                                 for s in st.values()),
                "launches": {k: counts[k] for k in
                             ("vexp", decode, "flash_attention")},
                "replayed": {k: replayed[k] for k in
                             ("vexp", decode, "flash_attention")},
                "peak_memory_bytes": peak, "clocks_power": clocks}
    return {"srv": srv, "reqs": reqs, "stats": st, "counts": counts,
            "readings": readings, "secs": secs, "peak": peak,
            "clocks": clocks}


def hybrid_replay_logits(cfg, params, reqs, policy, steps, gates=None,
                         checked=0):
    """Teacher-forced logits of ``reqs`` under ``policy`` as the engine
    serves them: one ragged prefill at the window's width (the fixed
    admission width), then one decode step per emitted token at the
    request's position (the ring wraps past 2048). Returns ``steps``
    (B, V) f32 logits; with ``gates`` (a GateCheck) the prefill and the
    first ``checked`` steps run under it."""
    from repro_torch.models import hybrid
    w = cfg.sliding_window
    plen = np.array([len(r.prompt) for r in reqs], np.int32)
    toks = np.zeros((len(reqs), w), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :plen[i]] = r.prompt
    pos = torch.as_tensor(plen, device="cuda")

    def advance(out, state, upto):
        while len(out) < upto:
            t = len(out) - 1
            tok = torch.as_tensor([[r.out[t]] for r in reqs],
                                  dtype=torch.int32, device="cuda")
            logits, state = hybrid.decode_step(params, cfg, tok, state,
                                               pos + t, policy=policy)
            out.append(logits[:, 0])
        return state

    with gates if gates is not None else contextlib.nullcontext():
        logits, state = hybrid.prefill(
            params, cfg, torch.as_tensor(toks, device="cuda"),
            prompt_len=torch.as_tensor(plen, device="cuda"), policy=policy)
        out = [logits[:, 0]]
        state = advance(out, state, checked)
    advance(out, state, steps)
    return out


def hybrid_forward_logits(cfg, params, reqs, policy):
    """The same logits from one ``forward`` (the associative scan and the
    windowed FlashAttention) over each request's prompt + its tokens:
    (steps, B, V)."""
    from repro_torch.models import hybrid
    rows = []
    for r in reqs:
        seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
        h = hybrid.forward(params, cfg, torch.as_tensor(seq[None],
                                                        device="cuda"),
                           policy=policy)
        rows.append(hybrid._logits(params, cfg,
                                   h[:, len(r.prompt) - 1:])[0])
    return torch.stack(rows, dim=1)


def hybrid_replays(cfg, params, groups, reqs, gates):
    """For 2 served requests a group (the first of them wraps the ring),
    one teacher-forced replay on the cuda tier over all their tokens,
    whose prefill and first SSM_TIER_STEPS steps run under ``gates``: its
    first SSM_TIER_STEPS logits against the reference tier's (limit
    REPLAY_LOGIT_TOL), and all of them against one forward over the same
    tokens (the two forms, limit HYBRID_FORM_LIMIT x max |logit|)."""
    tiers, forms = {}, {}
    for name, pol in groups.items():
        two = [r for r in reqs if r.group == name][:2]
        dec = hybrid_replay_logits(cfg, params, two, pol, len(two[0].out),
                                   gates, SSM_TIER_STEPS)
        ref = hybrid_replay_logits(cfg, params, two,
                                   pol.replace(kernel_backend="reference"),
                                   SSM_TIER_STEPS)
        tiers[name] = check_replay(f"hybrid {name}", two,
                                   dec[:SSM_TIER_STEPS], ref)
        dec = torch.stack(dec)
        full = hybrid_forward_logits(cfg, params, two, pol)
        gap = float((dec - full).abs().max())
        top = float(full[..., :cfg.vocab].abs().max())
        limit = HYBRID_FORM_LIMIT[pol.exp_backend]
        if not bool(torch.isfinite(full).all()) or gap > limit * top:
            fail(f"hybrid {name}: decode vs forward logits differ by {gap} "
                 f"(limit {limit} x max |logit| {top})")
        forms[name] = {"max_abs_gap": gap, "max_abs_logit": top,
                       "relative": gap / top,
                       "prompt_lens": [len(r.prompt) for r in two]}
        del dec, ref, full
    return {"tier_max_abs_logit_diff": tiers, "forms": forms}


HYBRID_FA_WINDOW = 2048


def hybrid_fa_inputs():
    """B3's inputs at the hybrid's shapes, from seed 11: the admission
    prefill's q (B 8, S 2048, H 16, D 256), the ring's K and V (one KV
    head) and ragged kv_len in [32, 2048] (row 0 full); a chunk's q
    (HYBRID_CHUNK rows) with its (B,) offsets and token counts (row 3
    none). Returns (q, k, v, kv_len, q_chunk, offsets, tokens)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    b, s, h, hkv, d = 8, 2048, 16, 1, 256
    q = torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    kv_len = torch.randint(32, s + 1, (b,), generator=g, device="cuda",
                           dtype=torch.int32)
    kv_len[0] = s
    qc = torch.randn(b, HYBRID_CHUNK, h, d, generator=g,
                     device="cuda").to(torch.bfloat16)
    offs = torch.tensor([0, 256, 1792, 0, 1000, 512, 1500, 1536],
                        dtype=torch.int32, device="cuda")
    clens = torch.tensor([256, 256, 256, 0, 200, 37, 256, 100],
                         dtype=torch.int32, device="cuda")
    return q, k, v, kv_len, qc, offs, clens


def _hybrid_fa_rows(fa, policy_cls, block_k):
    """B3 at the hybrid's shapes: the admission prefill (B 8, H 16 on one
    KV head, D 256, S 2048, window 2048, ragged kv_len) and a chunk (256
    query rows at per-row offsets given as a (B,) tensor over the
    2048-row ring, kv_len = offset + tokens, window 2048); plus the
    prefill under a window of 700 that cuts the keys. Returns (fields,
    [(tag, readings)])."""
    q, k, v, kv_len, qc, offs, clens = hybrid_fa_inputs()
    b, s, h, d = q.shape
    hkv, win, sq = k.shape[2], HYBRID_FA_WINDOW, qc.shape[1]
    res, rd = _fa_case(fa, policy_cls, block_k, q, k, v, kv_len, 0, "",
                       window=win)
    out = [("d256", rd)]
    cut, rd_cut = _fa_case(fa, policy_cls, block_k, q, k, v, kv_len, 0,
                           "w700_", window=700)
    res.update({k_: cut[k_] for k_ in cut if "max_abs_err" in k_
                or "mismatch_share" in k_})
    out.append(("d256 window 700", rd_cut))
    chunk, rd_chunk = _fa_case(fa, policy_cls, block_k, qc, k, v,
                               offs + clens, offs, "chunk_", window=win)
    res.update(chunk)
    out.append(("d256 chunk", rd_chunk))
    res["shape"] = (f"B={b} S={s} H={h} Hkv={hkv} D={d} window={win}, "
                    f"ragged kv_len")
    res["chunk_shape"] = (f"B={b} Sq={sq} Sk={s} H={h} Hkv={hkv} D={d} "
                          f"window={win}, (B,) q_offset tensor")
    edges, edge_rds = _fa_edges(fa, policy_cls, q, k, v, qc, win, "d256")
    res["edges"] = edges
    return res, out + edge_rds


def _largest_block_k(fa, d):
    """The largest block_k (in steps of 32 keys, up to 4,096) whose score
    tile the card's shared memory holds at head dim d."""
    import ctypes
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    smem = fa.LIB.fn("fa_smem_bytes", [ctypes.c_int, ctypes.c_int],
                     ctypes.c_longlong)
    return max(bk for bk in range(32, 4097, 32) if smem(d, bk) <= limit)


def _fa_edges(fa, policy_cls, q, k, v, qc, window, label):
    """B3 at fa_rows' head dims where the 64-row (position, head) tiles
    and the 32-key groups have their edges, each at block_k 128 and at
    the largest the card admits: a prefill of 1,021 queries (not a whole
    number of tiles: 4 positions a tile at G 16, 16 at G 4) over rows
    with kv_len 1, 1,021, 640 and 333; and a chunk of 61 queries at (B,)
    offsets, one row whose last query sits at key 2,047 (the cache's
    last), one with a single token at offset 0 (kv_len 1), one mid-cache,
    one of three tokens. Each held to its plain version under every
    backend with the controls. Returns (fields, [(tag, readings)])."""
    dev = q.device
    sk = k.shape[1]
    tail_len = torch.tensor([1, 1021, 640, 333], dtype=torch.int32,
                            device=dev)
    offs = torch.tensor([sk - 61, 0, 1000, 1984], dtype=torch.int32,
                        device=dev)
    toks = torch.tensor([61, 1, 61, 3], dtype=torch.int32, device=dev)
    cases = {"tail": (q[:4, :1021], k[:4], v[:4], tail_len, 0),
             "ring_end": (qc[:4, :61], k[:4], v[:4], offs + toks, offs)}
    top = _largest_block_k(fa, q.shape[-1])
    res, out = {"largest_block_k": top}, []
    for name, (qe, ke, ve, kv, off) in cases.items():
        for bk in (128, top):
            rd, _ = _fa_readings(fa, policy_cls, bk, qe, ke, ve, kv, off,
                                 window)
            tag = f"{name}_bk{bk}"
            for (exp, who), (err, share, _) in rd.items():
                res[f"{tag}_{exp}_{who}_max_abs_err"] = err
                res[f"{tag}_{exp}_{who}_mismatch_share"] = share
            out.append((f"{label} {tag}", rd))
    return res, out


def hybrid_decode_inputs(da, paged):
    """The inputs of B2 (or B7 through a page-64 ring table in random
    order) at the hybrid's decode shape: B 8, one KV head, G 16, d 256,
    a 2048-slot ring whose cache_len is below and at the window (two rows
    full, the rest drawn in [33, 2048]), "bshd", from seed 12 (13 paged).
    Returns (q, cache_len, k, v, run): k and v the contiguous cache (paged:
    the pool gathered through the table) and run(policy) the kernel's
    call."""
    return decode_inputs(da, paged, b=8, s=2048, h=16, hkv=1, d=256,
                         page=HYBRID_PAGE, seed=12 + int(paged), full=2)


def decode_inputs(da, paged, *, b, s, h, hkv, d, page, seed, full,
                  layout="bshd"):
    """B2's inputs (or B7's through a page table in random order): q (B,
    1, H, d), cache_len drawn in [33, s] from ``seed`` with the first
    ``full`` rows at s, and K / V of ``hkv`` heads over s positions
    ("bshd", or "bhsd" for B2). Returns (q, cache_len, k, v, run): k and
    v the contiguous cache in ``layout`` (paged: the pool gathered
    through the table, "bshd") and run(policy) the kernel's call."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ns = s // page
    q = torch.randn(b, 1, h, d, generator=g, device="cuda").to(torch.bfloat16)
    cl = torch.randint(33, s + 1, (b,), generator=g, device="cuda",
                       dtype=torch.int32)
    cl[:full] = s
    if paged:
        kp, vp = (torch.randn(1 + b * ns, page, hkv, d, generator=g,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        tab = ((torch.randperm(b * ns, generator=g, device="cuda") + 1)
               .reshape(b, ns).to(torch.int32))
        kc, vc = da.paged_gather(kp, tab), da.paged_gather(vp, tab)
    else:
        kc, vc = (torch.randn(b, s, hkv, d, generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        if layout == "bhsd":
            kc, vc = (t.transpose(1, 2).contiguous() for t in (kc, vc))

    def run(pol):
        if paged:
            return da.decode_attention_paged(q, kp, vp, tab, cl,
                                             layout="bshd", policy=pol)
        return da.decode_attention(q, kc, vc, cl, layout=layout, policy=pol)
    return q, cl, kc, vc, run


def _hybrid_decode_case(da, policy_cls, paged):
    """B2 (or B7) on ``hybrid_decode_inputs`` (``_decode_case``)."""
    return _decode_case(da, policy_cls, paged,
                        hybrid_decode_inputs(da, paged), HYBRID_PAGE, "d256")


def _decode_case(da, policy_cls, paged, inputs, page, label,
                 layout="bshd", stages=True):
    """B2 (or B7) on ``inputs`` (``decode_inputs``' tuple, the cache in
    ``layout``): held to its plain version under every exp backend, with
    the half-block (half-page) and textbook-merge controls; graph ms,
    device µs per CUDA kernel, SDPA's graph ms (over the gathered pages
    for B7; GQA through ``enable_gqa``), the plain version's ms and the
    bound; with ``stages``, device µs per CUDA kernel (torch.profiler,
    ~3 s a case). Returns (fields, readings)."""
    q, cl, kc, vc, run = inputs
    b, _, h, d = q.shape
    s, hkv = (kc.shape[2], kc.shape[1]) if layout == "bhsd" else \
        (kc.shape[1], kc.shape[2])
    readings = {}
    block = page if paged else policy_cls().block_s
    for exp in EXP_BACKENDS:
        pol = policy_cls(exp_backend=exp, block_page=page)
        ref = da.decode_attention_plain(q, kc, vc, cl, layout=layout,
                                        block_s=block, exp_backend=exp)
        readings[exp, "kernel"] = kernel_vs_plain(run(pol), ref)
        if exp != "exact":
            half = da.decode_attention_plain(q, kc, vc, cl, layout=layout,
                                             block_s=block // 2,
                                             exp_backend=exp)
            readings[exp, "half_page" if paged else "half_block"] = \
                kernel_vs_plain(half, ref)
            tb = textbook_partial(q, kc, vc, cl, 0, layout=layout, exp=exp)
            readings[exp, "textbook_merge"] = kernel_vs_plain(
                _norm_stats(*tb).reshape(ref.shape), ref)
    res = {f"{exp}_{who}_{m}": val[i]
           for (exp, who), val in readings.items()
           for i, m in enumerate(("max_abs_err", "mismatch_share"))}
    pol = policy_cls(exp_backend="vexp", block_page=page)
    res["ms_vexp"] = cuda_time_ms(lambda: run(pol), iters=50)
    res["graph_ms_vexp"] = graph_ms(lambda: run(pol),
                                    f"decode {label} paged={paged}", iters=50)
    if stages:
        res["stage_us_vexp"] = stage_device_us(lambda: run(pol))
    res["plain_ms_vexp"] = cuda_time_ms(lambda: da.decode_attention_plain(
        q, kc, vc, cl, layout=layout, block_s=block, exp_backend="vexp"),
        iters=5)
    qt = q.transpose(1, 2)
    kt, vt = (kc, vc) if layout == "bhsd" else \
        (kc.transpose(1, 2), vc.transpose(1, 2))
    mask = (torch.arange(s, device="cuda")[None, :]
            < cl[:, None])[:, None, None]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    res["library_ms"] = cuda_time_ms(sdpa, iters=50)
    res["library_graph_ms"] = graph_ms(sdpa, f"sdpa (decode {label})",
                                       iters=50)
    live = float(cl.double().sum())
    if paged:            # whole live pages of K and V
        live_keys = float(((cl + page - 1) // page).double().sum()) * page
    else:
        live_keys = live
    nbytes = live_keys * hkv * d * 2 * 2 + 2 * b * h * d * 2
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 4.0 * live * h * d,
                                                BF16_FLOP_PER_S)
    res["cache_len"] = cl.tolist()
    res["shape"] = (f"B={b} Hkv={hkv} G={h // hkv} d={d} cache={s}"
                    + (f" page={page}" if paged else "") + f", {layout}")
    return res, readings


HYBRID_EDGE_LENS = (1, 64, 65, 511, 512, 513, 2048)
HYBRID_EDGE_GROUPS = (1, 5, 16)          # MAX_GROUP[128, 256] is 16
HYBRID_EDGE_WINDOW = 700


def _decode_edges(da, policy_cls, d=256, seed=14,
                  groups=HYBRID_EDGE_GROUPS, page128_groups=(),
                  lens=HYBRID_EDGE_LENS):
    """B2 and B7 at head dim ``d`` (256, or 128) where the chained sweep
    has its edges: ``groups`` query rows on one KV head (G 1, 5 and 16;
    at head dim 128 G 1 to 4 take the four-row tier, G 5 to 8 the
    eight-row one and G 9 to 16 the sixteen-row path, so dbrx's phase
    takes G 5, 6, 8 and 9, each side of the eight-row tier's bounds); one
    row per cache_len in ``lens`` (HYBRID_EDGE_LENS: one key, a tile, a
    tile and a key, around the 512-key update block, the full 2,048-row
    cache; the cache is as long as the longest); with
    no window and with a window of 700 (the first kept key mid-block); B7
    through a page table in random order. At head dim 128 also B7 at each
    G of ``page128_groups`` (phi3's phase G 4, dbrx's G 6) through pages
    of two tiles (128 keys), where the four- and eight-row sweeps' stage
    2 rings its V tiles within a page. Each held to its plain version
    under every exp backend, with the half-block (half-page) and
    textbook-merge controls. Returns (fields, [(tag, kernel,
    readings)])."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s, page = max(lens), HYBRID_PAGE
    b, ns = len(lens), s // page
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kp, vp = (torch.randn(1 + b * ns, page, 1, d, generator=g,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2))
    tab = ((torch.randperm(b * ns, generator=g, device="cuda") + 1)
           .reshape(b, ns).to(torch.int32))
    kc, vc = da.paged_gather(kp, tab), da.paged_gather(vp, tab)
    qs = {grp: torch.randn(b, 1, grp, d, generator=g,
                           device="cuda").to(torch.bfloat16)
          for grp in groups}
    pools = {page: (kp, vp, tab)}
    cases = [(grp, window, paged, page) for grp in groups
             for window in (None, HYBRID_EDGE_WINDOW)
             for paged in (False, True)]
    if page128_groups:
        for grp in page128_groups:
            if grp not in qs:
                qs[grp] = torch.randn(b, 1, grp, d, generator=g,
                                      device="cuda").to(torch.bfloat16)
        big, nb2 = 2 * page, s // (2 * page)
        tab2 = ((torch.randperm(b * nb2, generator=g, device="cuda") + 1)
                .reshape(b, nb2).to(torch.int32))
        pools[big] = tuple(
            torch.zeros(1 + b * nb2, big, 1, d, dtype=torch.bfloat16,
                        device="cuda").index_copy_(
                0, tab2.reshape(-1).long(), x.reshape(b * nb2, big, 1, d))
            for x in (kc, vc)) + (tab2,)
        assert torch.equal(da.paged_gather(pools[big][0], tab2), kc)
        cases += [(grp, window, True, big) for grp in page128_groups
                  for window in (None, HYBRID_EDGE_WINDOW)]
    res, out = {}, []
    for grp, window, paged, pg in cases:
        q = qs[grp]
        kernel = "decode_attention_paged" if paged else "decode_attention"
        block = pg if paged else policy_cls().block_s
        readings = {}
        for exp in EXP_BACKENDS:
            pol = policy_cls(exp_backend=exp, block_page=pg)
            if paged:
                got = da.decode_attention_paged(
                    q, *pools[pg], cl, window=window, layout="bshd",
                    policy=pol)
            else:
                got = da.decode_attention(q, kc, vc, cl, window=window,
                                          layout="bshd", policy=pol)
            ref = da.decode_attention_plain(
                q, kc, vc, cl, window=window, layout="bshd",
                block_s=block, exp_backend=exp)
            readings[exp, "kernel"] = kernel_vs_plain(got, ref)
            if exp != "exact":
                half = da.decode_attention_plain(
                    q, kc, vc, cl, window=window, layout="bshd",
                    block_s=block // 2, exp_backend=exp)
                readings[exp, "half_page" if paged else "half_block"] = \
                    kernel_vs_plain(half, ref)
                tb = textbook_partial(q, kc, vc, cl, 0, layout="bshd",
                                      exp=exp, window=window)
                readings[exp, "textbook_merge"] = kernel_vs_plain(
                    _norm_stats(*tb).reshape(ref.shape), ref)
        tag = (f"g{grp}_w{window or 0}_"
               + (f"paged{pg if pg != page else ''}" if paged
                  else "contig"))
        for (exp, who), val in readings.items():
            res[f"{tag}_{exp}_{who}_max_abs_err"] = val[0]
            res[f"{tag}_{exp}_{who}_mismatch_share"] = val[1]
        out.append((tag, kernel, readings))
    res["cache_len"] = list(lens)
    return res, out


def phase_hybrid_kernels(policy_cls):
    """B3, B2 and B7 at recurrentgemma-9b's shapes (head dim 256, 16 query
    heads on one KV head, a 2048-token window; FA at the config's
    ``attn_block_k`` of 512, the update block its serve runs, and its
    edge cases at block_k 128 and the largest the card admits), each held
    to its plain version under the unchanged ATT_LIMITS with its
    negative controls; FA's rows also carry their CUDA-core FMA floor
    (a reading). Returns {kernel row name: fields} for the kernel
    table."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime import resolve_policy
    block_k = resolve_policy(get_config(HYBRID_ARCH), env={}).block_k
    fa_res, fa_checks = _hybrid_fa_rows(fa, policy_cls, block_k)
    dec, dec_rd = _hybrid_decode_case(da, policy_cls, False)
    pdec, pdec_rd = _hybrid_decode_case(da, policy_cls, True)
    edges, edge_rds = _decode_edges(da, policy_cls)
    emit({"phase": "hybrid_attention_kernels", "block_k": block_k,
          "flash_attention": fa_res, "decode_attention": dec,
          "decode_attention_paged": pdec, "decode_edges": edges})
    for tag, rd in fa_checks:
        check_attention("flash_attention", rd, f" {tag}")
    check_attention("decode_attention", dec_rd, " d256 g16")
    check_attention("decode_attention_paged", pdec_rd, " d256 g16")
    for tag, kernel, rd in edge_rds:
        check_attention(kernel, rd, f" d256 {tag}")
    keys = ("ms_vexp", "graph_ms_vexp", "plain_ms_vexp", "bound_ms",
            "bound_by", "library_ms", "library_graph_ms", "shape")
    # the decode rows also carry their per-kernel device µs
    dec_keys = keys + ("stage_us_vexp",)

    def worst(rd):
        return max(e for (_, who), (e, *_) in rd.items() if who == "kernel")
    fa_keys = keys + ("fma_floor_ms", "sm_clock_mhz")
    fa_row = {k: fa_res[k] for k in fa_keys}
    fa_row.update({f"chunk_{k}": fa_res[f"chunk_{k}"] for k in fa_keys
                   if f"chunk_{k}" in fa_res})
    fa_row["chunk_shape"] = fa_res["chunk_shape"]
    fa_row["max_abs_err"] = max(worst(rd) for _, rd in fa_checks)
    out = {"flash_attention_bhsd": fa_row}
    for name, res, rd, kernel in (
            ("decode_attention_kernel", dec, dec_rd, "decode_attention"),
            ("decode_attention_kernel_paged", pdec, pdec_rd,
             "decode_attention_paged")):
        row = {k: res[k] for k in dec_keys}
        row["max_abs_err"] = max([worst(rd)] + [
            worst(e) for _, k, e in edge_rds if k == kernel])
        out[name] = row
    return out


def hybrid_step_readings(srv):
    """Per busy group: the graph ms of one decode step replayed back to
    back on its live pool (positions advance by at most 11 rows), the
    launches a replay holds, and the device kernels of one step from a
    profile window of one replay."""
    out = ssm_step_readings(srv)
    for name, g in srv._groups.items():
        if name in out:
            out[name]["launches_per_step"] = dict(g.state.graph.launches)
    return out


def phase_serve_hybrid(kernels, smi, cfg, params, policy, groups):
    """Full-width recurrentgemma-9b through the port's Server: max_batch
    8, max_seq 4,096 (the cache is the 2,048-token window), 16 requests
    with prompts in [32, 2000], four of them in [1990, 2040] so that their
    decode wraps the ring (seed 0), 64 new tokens, groups eval=exact,
    bulk=vexp, hw=vexp_hw; the graph and eager arms in turns (graph,
    eager, graph, eager), then the capture audit (the whole mixed carry),
    the decode step's graph ms per group with its kernels, the gate exps
    against their plain versions (a short eager serve at the serve's
    shapes and the replays), the replays (cuda tier against reference
    tier, decode against forward). Returns ({path: launch counts}, the
    first graph turn's requests)."""
    from repro_torch.analysis import graph_audit

    def server(cuda_graphs=True, grp=groups):
        return hybrid_server(cfg, params, policy, grp, cuda_graphs)

    t0 = time.perf_counter()
    for arm in ARMS:                     # warm-up, not measured
        server(arm == "graph").run(hybrid_requests(cfg, groups, 3, 4,
                                                   seed=1))
    torch.cuda.synchronize()
    secs = {"warm_up": time.perf_counter() - t0}
    runs = {arm: [] for arm in ARMS}
    for _ in range(ARM_TURNS):
        for arm in ARMS:
            turn = hybrid_serve_once(kernels, cfg, server,
                                     lambda: hybrid_requests(cfg, groups),
                                     arm, 0, "decode_attention",
                                     f"serve_hybrid ({arm} arm)")
            del turn["srv"]
            runs[arm].append(turn)
    compare = compare_arms(runs, "serve_hybrid")
    first = runs["graph"][0]
    reqs = first["reqs"]
    secs["turns"] = time.perf_counter() - t0 - sum(secs.values())
    live = hybrid_requests(cfg, groups, max_new=8, seed=3)
    srv = ssm_live_server(server, live)
    audits = {}
    for name, g in srv._groups.items():
        if g.busy:
            try:
                audits[name] = graph_audit.capture_audit(g.state, g.last,
                                                         g.live_dev)
            except graph_audit.AuditError as e:
                fail(f"serve_hybrid capture audit, group {name}: {e}")
    steps = hybrid_step_readings(srv)
    del srv
    secs["audit_and_step"] = time.perf_counter() - t0 - sum(secs.values())
    gates = GateCheck()
    reqs_g = hybrid_requests(cfg, groups, max_new=HYBRID_GATE_SERVE_NEW)
    with gates:
        server(False).run(reqs_g)
    check_requests(cfg, reqs_g, HYBRID_GATE_SERVE_NEW)
    checked = {"serve": dict(gates.calls)}
    secs["gate_serve"] = time.perf_counter() - t0 - sum(secs.values())
    replays = hybrid_replays(cfg, params, groups, reqs, gates)
    checked["serve_and_replays"] = dict(gates.calls)
    secs["replays"] = time.perf_counter() - t0 - sum(secs.values())
    wrapped = [r.rid for r in reqs if len(r.prompt) + len(r.out) - 1
               > cfg.sliding_window]
    if len(wrapped) < 4:
        fail(f"serve_hybrid: {len(wrapped)} requests wrapped the ring")
    emit({"phase": "serve_hybrid", "arch": cfg.arch_id,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
          "head_dim": cfg.hd, "lru_width": cfg.lru_width,
          "window": cfg.sliding_window, "vocab_padded": cfg.vocab_padded,
          "arm": "graph", **first["readings"],
          "prompt_lens": [len(r.prompt) for r in reqs],
          "ring_wrapped_requests": wrapped,
          "turns": {arm: [t["readings"] for t in runs[arm]] for arm in ARMS},
          "graph_vs_eager_tokens": compare, "capture_audit": audits,
          "step_graph": steps, **replays, "gate_exps_checked": checked,
          "gate_exp_max_ulp": gates.max_ulp, "form_limit": HYBRID_FORM_LIMIT,
          "phase_seconds": secs, "nvidia_smi": smi})
    return ({"serve_hybrid": first["counts"],
             "serve_hybrid_eager": runs["eager"][0]["counts"]}, reqs)


def phase_serve_hybrid_paged(kernels, smi, cfg, params, policy, groups,
                             mono):
    """The serve_hybrid requests on the paged ring pools (page 64, 32 ring
    pages a slot, allocated whole at admission), graph arm: B7 on every
    decode step; no page held after the serve. Its tokens equal, request
    by request, those of a contiguous ring serve of the same requests
    whose groups update once per 64 keys (``block_s`` = the page, B2 on
    every step), the same function; against the serve_hybrid tokens
    (``mono``, one update per 512 keys, another function under vexp) the
    first divergences and their reference top-2 gaps are a note. Returns
    ({path: counts}, the paged serve's requests)."""
    grp = {n: p.replace(block_page=HYBRID_PAGE, block_s=HYBRID_PAGE)
           for n, p in groups.items()}
    pol = policy.replace(block_page=HYBRID_PAGE, block_s=HYBRID_PAGE)
    turns = {}
    for paged in (False, True):
        what = "serve_hybrid_paged" if paged else "serve_hybrid_block64"

        def server(cuda_graphs=True):
            return hybrid_server(cfg, params, pol, grp, cuda_graphs,
                                 paged=paged)

        turns[what] = hybrid_serve_once(
            kernels, cfg, server, lambda: hybrid_requests(cfg, groups),
            "graph", 0, "decode_attention_paged" if paged
            else "decode_attention", what)
    turn, ring = turns["serve_hybrid_paged"], turns["serve_hybrid_block64"]
    del ring["srv"]
    pools = {}
    for name, g in turn["srv"]._groups.items():
        pools[name] = g.state.pool_stats()
        if g.state.alloc.n_used():
            fail(f"serve_hybrid_paged group {name}: "
                 f"{g.state.alloc.n_used()} pages held after the serve")
    turn["srv"].assert_idle_clean()
    for r, want in zip(turn["reqs"], ring["reqs"]):
        if list(r.out) != list(want.out):
            i = next((i for i, (a, b) in enumerate(zip(r.out, want.out))
                      if a != b), min(len(r.out), len(want.out)))
            fail(f"serve_hybrid_paged: request {r.rid} ({r.group}) leaves "
                 f"the block-64 ring serve's tokens at step {i}")
    note = near_tie_compare(cfg, params, groups, turn["reqs"],
                            [r.out for r in mono], "paged hybrid request",
                            "the 512-block ring serve's tokens", check=False)
    emit({"phase": "serve_hybrid_paged", "page": HYBRID_PAGE,
          **turn["readings"], "block64_ring": ring["readings"],
          "vs_block64_ring": {"identical": len(ring["reqs"])},
          "note_vs_block512_ring": note, "pools": pools,
          "nvidia_smi": smi})
    return ({"serve_hybrid_block64": ring["counts"],
             "serve_hybrid_paged": turn["counts"]}, turn["reqs"])


def phase_serve_hybrid_chunked(kernels, smi, cfg, params, policy, groups,
                               mono):
    """The serve_hybrid requests with chunked prefill (256), contiguous and
    paged, graph arm: each group's chunk program a second graph built
    with the group, every chunk a replay; tokens equal the monolithic
    serve's (``mono``) up to a near tie (the RG-LRU's combine tree spans
    the chunk, not the window)."""
    out = {}
    for paged in (False, True):
        page = HYBRID_PAGE if paged else None
        pol, grp = chunked_groups(policy, groups, HYBRID_CHUNK, page)

        def server(cuda_graphs=True):
            return hybrid_server(cfg, params, pol, grp, cuda_graphs,
                                 paged=paged)

        what = "serve_hybrid_paged_chunked" if paged else \
            "serve_hybrid_chunked"
        turn = hybrid_serve_once(
            kernels, cfg, server, lambda: hybrid_requests(cfg, groups),
            "graph", 0, "decode_attention_paged" if paged
            else "decode_attention", what)
        vs = near_tie_compare(cfg, params, groups, turn["reqs"],
                              [r.out for r in mono], f"{what} request",
                              "the monolithic serve's tokens")
        emit({"phase": what, "chunk": HYBRID_CHUNK, **turn["readings"],
              "vs_monolithic": vs, "nvidia_smi": smi})
        out[what] = turn["counts"]
        del turn
    return out


def phase_serve_hybrid_spec(kernels, smi, cfg, params, policy, groups,
                            mono, mono_paged):
    """The serve_hybrid requests under self-speculative decode (spec_k 4,
    drafts under vexp_hw, the "recurrent" scan verify; paged:
    "recurrent_paged"), graph arm: every burst k draft replays and one
    verify replay; tokens equal the plain serve's request by request,
    on each pool the plain serve of that pool (``mono``, ``mono_paged``);
    the hw group's own-backend drafts all accepted."""
    out = {}
    for paged, plain in ((False, mono), (True, mono_paged)):
        grp = spec_policy_groups(groups, "scan",
                                 HYBRID_PAGE if paged else None)

        def server(cuda_graphs=True):
            return hybrid_server(cfg, params, policy, grp, cuda_graphs,
                                 paged=paged)

        what = "serve_hybrid_paged_spec" if paged else "serve_hybrid_spec"
        turn = hybrid_serve_once(
            kernels, cfg, server, lambda: hybrid_requests(cfg, groups),
            "graph", SPEC_K, "decode_attention_paged" if paged
            else "decode_attention", what)
        for r, want in zip(turn["reqs"], plain):
            if list(r.out) != list(want.out):
                i = next((i for i, (a, b) in enumerate(
                    zip(r.out, want.out)) if a != b),
                    min(len(r.out), len(want.out)))
                fail(f"{what}: request {r.rid} ({r.group}) leaves the "
                     f"plain serve's tokens at step {i}")
        vs = {"identical": len(plain)}
        control = check_own_draft_control(cfg, turn["stats"], turn["reqs"],
                                          "hw", "scan", what)
        emit({"phase": what, "spec_k": SPEC_K, "draft": "vexp_hw",
              "verify": "recurrent_paged scan" if paged
              else "recurrent scan",
              **spec_readings(turn["reqs"], turn["stats"], turn["secs"],
                              turn["peak"], turn["clocks"]),
              "serve": turn["readings"], "vs_plain": vs,
              "own_draft_control": control, "nvidia_smi": smi})
        out[what] = turn["counts"]
        del turn
    return out


# ------------------------------------------ the SwiGLU dense family (phi3)

PHI3_ARCH = "phi3-medium-14b"
PHI3_MAX_SEQ = 2048
PHI3_PAGE = 64
PHI3_CHUNK = 256
PHI3_PROMPT = (32, 1024)
PHI3_TIER_STEPS = 16           # teacher-forced steps of the tier check
# the serve_phi3 arms in turns: the eager arm once (an eager serve takes
# ~30 s at full width), every graph turn's tokens held to it
PHI3_ARM_TURNS = ("graph", "eager")
# phi3's cuda tier against its reference tier over a teacher-forced
# replay (the decode kernels round q and p to bf16 where the reference
# tier keeps f32, as the Pallas kernels do, and bf16 activations carry
# that through 40 layers): max |cuda - reference| <= PHI3_TIER_LIMIT[exp]
# x max |logit|, and every served token the reference argmax where its
# top two are more than twice that apart. Twice the JAX package's own
# pallas-vs-reference gap under this check's conditions: phi3's widths,
# prompts of 300 and 1,000 tokens, 16 forced steps, read at 2, 4, 6 and
# 8 layers (0.00984 / 0.01110 / 0.01176, 0.01216 / 0.01209 / 0.01378,
# 0.01337 / 0.01373 / 0.01545 and 0.01324 / 0.01310 / 0.01569 of max
# |logit| under exact / vexp / vexp_hw) and carried to 40 by the power
# law the four readings fit (tools/tier_gap.py --width full --layers 6 8
# --prior <the 2 / 4 lines> --extrapolate 40: powers 0.23 / 0.14 / 0.22,
# 0.01992 / 0.01704 / 0.02280 at 40). REPLAY_LOGIT_TOL's 0.1 was set on
# gpt2-small's 12 layers and logits of magnitude ~1.
PHI3_TIER_LIMIT = {"exact": 0.0398, "vexp": 0.0341, "vexp_hw": 0.0456}


def d128_fa_inputs(h, hkv, seed, d=128, sq=1024, s=PHI3_MAX_SEQ):
    """B3's inputs at head dim ``d`` (128), from ``seed``: a wave's q (B
    8, ``sq`` (1024) positions, ``h`` query heads) over K and V of
    ``hkv`` KV heads with ragged kv_len in [32, sq] (row 0 full); a
    chunk's q (PHI3_CHUNK rows) with its (B,) offsets and token counts
    (row 3 none) over an ``s``-position (2,048) cache, of which the wave
    reads the first ``sq``. Returns (q, k, v, kv_len, q_chunk, offsets,
    tokens)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = 8
    q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    kv_len = torch.randint(32, sq + 1, (b,), generator=g, device="cuda",
                           dtype=torch.int32)
    kv_len[0] = sq
    qc = torch.randn(b, PHI3_CHUNK, h, d, generator=g,
                     device="cuda").to(torch.bfloat16)
    offs = torch.tensor([0, 256, 1792, 0, 1000, 512, 1500, 1536],
                        dtype=torch.int32, device="cuda")
    clens = torch.tensor([256, 256, 256, 0, 200, 37, 256, 100],
                         dtype=torch.int32, device="cuda")
    return q, k, v, kv_len, qc, offs, clens


def phi3_fa_inputs():
    """B3's inputs at phi3-medium's shapes (``d128_fa_inputs``: 40 query
    heads on 10 KV heads, G 4), from seed 21."""
    return d128_fa_inputs(40, 10, 21)


# B2 / B7 at phi3-medium's decode shape (``decode_inputs``' keywords): B 8,
# 40 query heads on 10 KV heads of 128, a 2,048-token cache, page 64
PHI3_DECODE_SHAPE = dict(b=8, s=PHI3_MAX_SEQ, h=40, hkv=10, d=128,
                         page=PHI3_PAGE, full=1)


def _d128_fa_rows(fa, policy_cls, block_k, inputs, label, chunk=True,
                  window=None, truth=True, cut_window=None, iters=20):
    """B3 on ``fa_rows<128>`` (head dim 128, or 120 on zero-filled
    columns) on ``inputs`` (``d128_fa_inputs``): the admission wave (B 8,
    ragged kv_len, causal, under ``window``; ``truth`` as ``_fa_case``),
    with ``cut_window`` the readings of the wave's first two rows again
    under a window that cuts their keys, with ``chunk`` a chunk (256
    query rows at (B,) offsets over 2,048 keys, kv_len = offset +
    tokens), then the edge cases (``_fa_edges``, under ``window``).
    Returns (fields, [(tag, readings)])."""
    q, k, v, kv_len, qc, offs, clens = inputs
    b, sq, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    res, rd = _fa_case(fa, policy_cls, block_k, q, k[:, :sq], v[:, :sq],
                       kv_len, 0, "", window=window, truth=truth,
                       iters=iters)
    out = [(label, rd)]
    res["shape"] = (f"B={b} S={sq} H={h} Hkv={hkv} D={d}, causal, ragged "
                    f"kv_len" + (f", window {window}" if window else ""))
    if cut_window is not None:        # rows 0 (every key) and 1
        rd_cut, _ = _fa_readings(fa, policy_cls, block_k, q[:2],
                                 k[:2, :sq], v[:2, :sq], kv_len[:2], 0,
                                 cut_window)
        for (exp, who), (err, share, _) in rd_cut.items():
            res[f"w{cut_window}_{exp}_{who}_max_abs_err"] = err
            res[f"w{cut_window}_{exp}_{who}_mismatch_share"] = share
        out.append((f"{label} window {cut_window}", rd_cut))
    if chunk:
        more, rd_chunk = _fa_case(fa, policy_cls, block_k, qc, k, v,
                                  offs + clens, offs, "chunk_")
        res.update(more)
        out.append((f"{label} chunk", rd_chunk))
        res["chunk_shape"] = (f"B={b} Sq={qc.shape[1]} Sk={s} H={h} "
                              f"Hkv={hkv} D={d}, (B,) q_offset tensor")
    edges, edge_rds = _fa_edges(fa, policy_cls, q, k, v, qc, window, label)
    res["edges"] = edges
    return res, out + edge_rds


def d128_kernel_rows(policy_cls, arch, fa_inputs, decode_shape, label,
                     seed, phase, edge_groups=HYBRID_EDGE_GROUPS,
                     page128_groups=(4,), bhsd=True, chunk=True,
                     fa_window=None, fa_truth=True, cut_window=None,
                     edge_lens=HYBRID_EDGE_LENS, fa_iters=20,
                     decode_stages=True):
    """B3, B2 and B7 at head dim 128 on ``arch``'s shapes: FA at the
    config's ``attn_block_k`` of 512 (its serve's update block; the edge
    cases at block_k 128 and the largest the card admits) on
    ``fa_inputs``, B2 over ``decode_shape``'s 2,048-token cache with
    ragged cache_len ("bshd", and with ``bhsd`` also "bhsd"), B7 through
    a page-64 table in random order (seeds from ``seed``), and both at
    their edges (``_decode_edges`` at D 128 with ``edge_groups`` query
    heads a KV head: cache_len at the tile and block bounds, a window;
    B7 at ``page128_groups`` also through pages of 128 keys; one row a
    cache_len of ``edge_lens``). The head dim is ``decode_shape``'s (128,
    or h2o-danube3's 120: FA's wave then under ``fa_window``, without
    the float64 truth where ``fa_truth`` is false, and again under
    ``cut_window``; its timings over ``fa_iters`` calls; B2's and B7's
    per-kernel µs with ``decode_stages``). Each held to
    its plain version under the unchanged ATT_LIMITS with its negative
    controls; FA's rows also carry their CUDA-core FMA floor (a
    reading). Emits one ``phase`` line; returns {kernel row name:
    fields} for the kernel table."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime import resolve_policy
    block_k = resolve_policy(get_config(arch), env={}).block_k
    fa_res, fa_checks = _d128_fa_rows(fa, policy_cls, block_k, fa_inputs,
                                      label, chunk, fa_window, fa_truth,
                                      cut_window, fa_iters)
    page = decode_shape["page"]
    dec, dec_rd = _decode_case(
        da, policy_cls, False,
        decode_inputs(da, False, seed=seed, **decode_shape), page, label,
        stages=decode_stages)
    pdec, pdec_rd = _decode_case(
        da, policy_cls, True,
        decode_inputs(da, True, seed=seed + 2, **decode_shape), page, label,
        stages=decode_stages)
    d = decode_shape["d"]
    edges, edge_rds = _decode_edges(da, policy_cls, d=d, seed=seed + 3,
                                    groups=edge_groups,
                                    page128_groups=page128_groups,
                                    lens=edge_lens)
    line = {"phase": phase, "block_k": block_k, "flash_attention": fa_res,
            "decode_attention": dec, "decode_attention_paged": pdec,
            "decode_edges": edges}
    checks = [("decode_attention", dec_rd, "bshd")]
    if bhsd:
        line["decode_attention_bhsd"], dech_rd = _decode_case(
            da, policy_cls, False,
            decode_inputs(da, False, seed=seed + 1, layout="bhsd",
                          **decode_shape), page, f"{label} bhsd",
            layout="bhsd", stages=False)
        checks.append(("decode_attention", dech_rd, "bhsd"))
    emit(line)
    g = decode_shape["h"] // decode_shape["hkv"]
    for tag, rd in fa_checks:
        check_attention("flash_attention", rd, f" {tag}")
    for kernel, rd, lay in checks:
        check_attention(kernel, rd, f" d{d} g{g} {lay}")
    check_attention("decode_attention_paged", pdec_rd, f" d{d} g{g}")
    for tag, kernel, rd in edge_rds:
        check_attention(kernel, rd, f" d{d} {tag}")
    keys = ("ms_vexp", "graph_ms_vexp", "plain_ms_vexp", "bound_ms",
            "bound_by", "library_ms", "library_graph_ms", "shape")

    def worst(rd):
        return max(e for (_, who), (e, *_) in rd.items() if who == "kernel")
    fa_keys = keys + ("fma_floor_ms", "sm_clock_mhz")
    fa_row = {k: fa_res[k] for k in fa_keys}
    if chunk:
        fa_row.update({f"chunk_{k}": fa_res[f"chunk_{k}"] for k in fa_keys
                       if f"chunk_{k}" in fa_res})
        fa_row["chunk_shape"] = fa_res["chunk_shape"]
    fa_row["max_abs_err"] = max(worst(rd) for _, rd in fa_checks)
    dec_row = {k: dec[k] for k in keys + ("stage_us_vexp",) if k in dec}
    dec_row["max_abs_err"] = max([worst(rd) for _, rd, _ in checks] + [
        worst(e) for _, k, e in edge_rds if k == "decode_attention"])
    if bhsd:
        dec_row["bhsd_graph_ms_vexp"] = \
            line["decode_attention_bhsd"]["graph_ms_vexp"]
    pdec_row = {k: pdec[k] for k in keys + ("stage_us_vexp",)
                if k in pdec}
    pdec_row["max_abs_err"] = max([worst(pdec_rd)] + [
        worst(e) for _, k, e in edge_rds if k == "decode_attention_paged"])
    return {"flash_attention_bhsd": fa_row,
            "decode_attention_kernel": dec_row,
            "decode_attention_kernel_paged": pdec_row}


def phase_phi3_kernels(policy_cls):
    """B3, B2 and B7 at phi3-medium-14b's shapes (head dim 128, 40 query
    heads on 10 KV heads, G 4; ``d128_kernel_rows``): FA's wave and
    chunk, B2 in both layouts, B7, and the edges at G 1, 5 and 16 (B7
    also at G 4 through pages of 128 keys). Returns the rows 3p, 4p and
    7p."""
    return d128_kernel_rows(policy_cls, PHI3_ARCH, phi3_fa_inputs(),
                            PHI3_DECODE_SHAPE, "d128", 22,
                            "phi3_attention_kernels")


def phi3_setup():
    """Full-width phi3-medium-14b (40 layers, d 5120, 40 heads on 10 KV
    heads of 128, SwiGLU d_ff 17920, untied vocab 100,352) with random
    weights drawn on the card from ``torch.Generator("cuda")
    .manual_seed(0)``, its default policy (the cuda tier) and the three
    policy groups."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.runtime import parse_policy_groups, resolve_policy
    cfg = get_config(PHI3_ARCH)
    params = api.init_params(cfg, 0, device="cuda")
    policy = resolve_policy(cfg, env={})
    if policy.kernel_backend != "cuda":
        fail(f"phi3: default tier is {policy.kernel_backend}, not cuda")
    groups = parse_policy_groups("eval=exact,bulk=vexp,hw=vexp_hw", cfg,
                                 base=policy)
    return cfg, params, policy, groups


def phi3_requests(cfg, groups, n=16, max_new=64, seed=0):
    """``n`` requests with prompts in PHI3_PROMPT from ``seed``, groups
    round-robin."""
    from repro_torch.launch.serve import make_requests
    lo, hi = PHI3_PROMPT
    return make_requests(cfg, n, hi, max_new, mixed_lengths=True,
                         min_len=lo, groups=sorted(groups), seed=seed)


def phi3_server(cfg, params, policy, groups, cuda_graphs=True, paged=False):
    """max_batch 8, max_seq 2,048 (a group's contiguous pool is 3.4 GB)."""
    from repro_torch.launch.serve import Server
    return Server(cfg, params, max_batch=8, max_seq=PHI3_MAX_SEQ,
                  policy=policy, policy_groups=groups, device="cuda",
                  cuda_graphs=cuda_graphs, paged=paged)


def check_phi3_serve(cfg, st, counts, replayed, sdpa_calls, arm, decode,
                     other, what, gates=1):
    """A phi3 (or dbrx) serve's launches and graphs: per decode step
    ``decode`` (B2 or B7) once a layer and the vexp kernel ``gates``
    times a layer (phi3: the SwiGLU gate; dbrx: the router softmax and
    the experts' SwiGLU gate), per admission wave or prefill chunk FA
    once and the vexp kernel ``gates`` times a layer; no other kernel,
    no SDPA call (``check_serve_counts``); graph arm: every step and
    chunk a replay of a graph captured with its group
    (``check_graph_stats``), the vexp launches of the steps and chunks
    all replayed. Returns (waves, chunks, steps)."""
    waves, chunks, steps = check_serve_counts(cfg, st, counts, sdpa_calls,
                                              decode, other, what)
    graphs = check_graph_stats(cfg, st, arm, replayed, decode, what)
    want = gates * cfg.n_layers * (steps + waves + chunks)
    if counts["vexp"] != want:
        fail(f"{what}: vexp launches {counts['vexp']} != {gates} x "
             f"{cfg.n_layers} layers x ({steps} steps + {waves} waves + "
             f"{chunks} chunks)")
    reps = sum(v[1] + v[3] for v in graphs.values())
    if replayed["vexp"] != gates * cfg.n_layers * reps:
        fail(f"{what}: {replayed['vexp']} replayed vexp launches != "
             f"{gates} x {cfg.n_layers} layers x {reps} step and chunk "
             f"replays")
    rest = {k: v for k, v in counts.items()
            if k not in ("vexp", decode, "flash_attention", "vexp_hw_table")
            and v}
    if rest:
        fail(f"{what}: launched {rest}")
    return waves, chunks, steps


def phi3_serve_once(kernels, cfg, make_server, make_reqs, arm, decode,
                    other, what, gates=1):
    """One serve with the launch counts set to 0 just before it and read
    just after, checked (``check_phi3_serve`` with ``gates`` vexp
    launches a layer); the server is dropped before it returns (two
    phi3 servers' pools together would crowd the weights). Returns the
    turn."""
    srv = make_server(arm == "graph")
    reqs = make_reqs()
    secs, counts, sdpa_calls, peak, clocks = timed_serve(kernels, srv, reqs)
    replayed = kernels.replay_counts()
    st = srv.stats()
    check_requests(cfg, reqs, reqs[0].max_new)
    waves, chunks, steps = check_phi3_serve(
        cfg, st, counts, replayed, sdpa_calls, arm, decode, other, what,
        gates)
    some = next(iter(st.values()))
    readings = {**serve_metrics(reqs, secs),
                "wall_per_decode_step_s": some["wall_per_decode_step_s"],
                "admit_waves": waves, "prefill_chunks": chunks,
                "decode_steps": steps,
                "admit_s_total": sum(s["admit_s_total"] for s in st.values()),
                "capture_s": sum(s["graph_capture_s"]
                                 + s["chunk_graph_capture_s"]
                                 for s in st.values()),
                "launches": {k: counts[k] for k in
                             ("vexp", decode, "flash_attention")},
                "replayed": {k: replayed[k] for k in
                             ("vexp", decode, "flash_attention")},
                "peak_memory_bytes": peak, "clocks_power": clocks}
    pools = {n: s["pool"] for n, s in st.items() if "pool" in s}
    if pools:
        srv.assert_idle_clean()       # drops the prefix cache's pages
        for name, g in srv._groups.items():
            if g.state.alloc.n_used():
                fail(f"{what} group {name}: {g.state.alloc.n_used()} pages "
                     f"held after the serve")
        readings["pools"] = pools
    del srv
    gc.collect()
    return {"reqs": reqs, "stats": st, "counts": counts,
            "readings": readings}


def phi3_step_bound(cfg, params, srv):
    """The decode step's bound on this card: every parameter but the
    embedding table read once (bf16 matmul weights, the f32
    unembedding, the norms) plus each live group's K and V up to its
    rows' positions (a ring: at most the window), over the HBM rate.
    Returns (bytes, ms)."""
    nbytes = sum(p.numel() * p.element_size()
                 for n, p in params.named_parameters() if n != "embed")
    out = {}
    kv_row = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2
    for name, g in srv._groups.items():
        if g.busy:
            live = g.live_dev.bool()
            held = g.state.pos_dev[live] + 1
            if cfg.sliding_window:
                held = torch.clamp(held, max=cfg.sliding_window)
            keys = float(held.double().sum())
            b = nbytes + keys * kv_row
            out[name] = {"bytes": b, "bound_ms": b / HBM_BYTES_PER_S * 1e3}
    return out


def phase_serve_phi3(kernels, smi, cfg, params, policy, groups):
    """Full-width phi3-medium-14b through the port's Server: max_batch 8,
    max_seq 2,048, 16 requests with prompts in [32, 1024] (seed 0), 64
    new tokens, groups eval=exact, bulk=vexp, hw=vexp_hw; the graph and
    eager arms in turns (PHI3_ARM_TURNS: graph, eager; every graph
    turn's tokens == the eager turn's), the capture audit, the decode
    step's graph ms and
    kernels per group against its bound, and a teacher-forced replay of
    2 requests a group whose every SwiGLU gate exp is held to its plain
    version (GateCheck) and whose cuda-tier logits are held to the
    reference tier's (REPLAY_LOGIT_TOL). Returns ({path: launch
    counts}, the first graph turn's requests)."""

    def server(cuda_graphs=True):
        return phi3_server(cfg, params, policy, groups, cuda_graphs)

    t0 = time.perf_counter()
    for arm in ARMS:                     # warm-up, not measured
        srv = server(arm == "graph")
        srv.run(phi3_requests(cfg, groups, 3, 4, seed=1))
        del srv
    torch.cuda.synchronize()
    secs = {"warm_up": time.perf_counter() - t0}
    runs = {arm: [] for arm in ARMS}
    for arm in PHI3_ARM_TURNS:
        runs[arm].append(phi3_serve_once(
            kernels, cfg, server, lambda: phi3_requests(cfg, groups),
            arm, "decode_attention", "decode_attention_paged",
            f"serve_phi3 ({arm} arm)"))
    compare = compare_arms(
        {"graph": runs["graph"], "eager": runs["eager"] * len(runs["graph"])},
        "serve_phi3")
    first = runs["graph"][0]
    reqs = first["reqs"]
    secs["turns"] = time.perf_counter() - t0 - sum(secs.values())
    audits = capture_audits(cfg, server, lambda: phi3_requests(
        cfg, groups, 6, 8, seed=3), "serve_phi3")
    srv = ssm_live_server(server, phi3_requests(cfg, groups, max_new=8,
                                                seed=3))
    steps = ssm_step_readings(srv)
    for name, b in phi3_step_bound(cfg, params, srv).items():
        steps[name].update(b)
        steps[name]["launches_per_step"] = dict(
            srv._groups[name].state.graph.launches)
    del srv
    secs["audit_and_step"] = time.perf_counter() - t0 - sum(secs.values())
    gates, tiers = GateCheck(), {}
    for name, pol in groups.items():
        two = [r for r in reqs if r.group == name][:2]
        with gates:
            fast = replay_logits(cfg, params, two, pol, PHI3_TIER_STEPS)
        ref = replay_logits(cfg, params, two,
                            pol.replace(kernel_backend="reference"),
                            PHI3_TIER_STEPS)
        top = max(float(lg[:, :cfg.vocab].abs().max()) for lg in ref)
        limit = PHI3_TIER_LIMIT[pol.exp_backend] * top
        tiers[name] = {"max_abs_diff": check_replay(f"phi3 {name}", two,
                                                    fast, ref, limit),
                       "max_abs_logit": top, "limit": limit}
    secs["replays"] = time.perf_counter() - t0 - sum(secs.values())
    emit({"phase": "serve_phi3", "arch": cfg.arch_id,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
          "head_dim": cfg.hd, "d_ff": cfg.d_ff, "act": cfg.act,
          "vocab_padded": cfg.vocab_padded, "arm": "graph",
          **first["readings"], "prompt_lens": [len(r.prompt) for r in reqs],
          "turns": {arm: [t["readings"] for t in runs[arm]] for arm in ARMS},
          "graph_vs_eager_tokens": compare, "capture_audit": audits,
          "step_graph": steps, "tier_max_abs_logit_diff": tiers,
          "gate_exps_checked": dict(gates.calls),
          "gate_exp_max_ulp": gates.max_ulp, "phase_seconds": secs,
          "nvidia_smi": smi})
    return ({"serve_phi3": first["counts"],
             "serve_phi3_eager": runs["eager"][0]["counts"]}, reqs)


def phase_serve_phi3_paged(kernels, smi, cfg, params, policy, groups, mono,
                           name="phi3", gates=1, make_server=None,
                           make_requests=None, page=PHI3_PAGE):
    """The serve_phi3 requests (or dbrx's, with ``name`` "dbrx" and its
    two gate exps a layer) on the paged pool (page 64), graph arm: B7 on
    every decode step, no page held after the serve; its tokens equal,
    request by request, those of a contiguous serve whose groups update
    once per 64 keys (``block_s`` = the page, B2 on every step), the same
    function. The requests share no prefix, so both serves prefill the
    same tokens. Against the monolithic serve's tokens (``mono``, one
    update per 512 keys, another function under vexp; phi3 only) the
    first divergences and their reference top-2 gaps are a note.
    ``make_server`` / ``make_requests`` (default phi3's) and ``page``
    serve another dense arch the same way (h2o-danube3: a ring table of
    64 pages a slot). Returns {path: counts}."""
    make_server = make_server or phi3_server
    make_requests = make_requests or phi3_requests
    grp = {n: p.replace(block_page=page, block_s=page)
           for n, p in groups.items()}
    pol = policy.replace(block_page=page, block_s=page)
    turns = {}
    for paged in (False, True):
        what = f"serve_{name}_paged" if paged else f"serve_{name}_block64"
        turns[what] = phi3_serve_once(
            kernels, cfg, lambda cg=True, pg=paged: make_server(
                cfg, params, pol, grp, cg, paged=pg),
            lambda: make_requests(cfg, groups), "graph",
            "decode_attention_paged" if paged else "decode_attention",
            "decode_attention" if paged else "decode_attention_paged", what,
            gates)
    turn = turns[f"serve_{name}_paged"]
    ring = turns[f"serve_{name}_block64"]
    for r, want in zip(turn["reqs"], ring["reqs"]):
        if list(r.out) != list(want.out):
            i = next((i for i, (a, b) in enumerate(zip(r.out, want.out))
                      if a != b), min(len(r.out), len(want.out)))
            fail(f"serve_{name}_paged: request {r.rid} ({r.group}) leaves "
                 f"the block-64 contiguous serve's tokens at step {i}")
    line = {"phase": f"serve_{name}_paged", "page": page,
            **turn["readings"], "block64_contiguous": ring["readings"],
            "vs_block64_contiguous": {"identical": len(ring["reqs"])},
            "nvidia_smi": smi}
    if mono is not None:
        line["note_vs_block512_contiguous"] = near_tie_compare(
            cfg, params, groups, turn["reqs"], [r.out for r in mono],
            f"paged {name} request", "the 512-block contiguous serve's "
            "tokens", check=False)
    emit(line)
    return {f"serve_{name}_block64": ring["counts"],
            f"serve_{name}_paged": turn["counts"]}


def phase_serve_phi3_chunked(kernels, smi, cfg, params, policy, groups,
                             mono):
    """The serve_phi3 requests with chunked prefill (256) on the
    contiguous pool, graph arm: each group's chunk program a second graph
    built with the group, every chunk a replay (FA and the gate's vexp
    once a layer a chunk); tokens equal the monolithic serve's (``mono``)
    up to a near tie."""
    pol, grp = chunked_groups(policy, groups, PHI3_CHUNK)
    turn = phi3_serve_once(
        kernels, cfg, lambda cg=True: phi3_server(cfg, params, pol, grp, cg),
        lambda: phi3_requests(cfg, groups), "graph", "decode_attention",
        "decode_attention_paged", "serve_phi3_chunked")
    vs = near_tie_compare(cfg, params, groups, turn["reqs"],
                          [r.out for r in mono], "chunked phi3 request",
                          "the monolithic serve's tokens")
    emit({"phase": "serve_phi3_chunked", "chunk": PHI3_CHUNK,
          **turn["readings"], "vs_monolithic": vs, "nvidia_smi": smi})
    return {"serve_phi3_chunked": turn["counts"]}


# ------------------------------------------------------- the MoE family

DBRX_ARCH = "dbrx-132b"
# dbrx-132b at full width with its depth cut from 40 layers to 8: a layer
# is ~6.5 GB of bf16 weights (16 experts of 3 x 6144 x 10752), the untied
# f32 embedding and unembedding 4.9 GB, so 8 layers are ~52 GB and the
# serve peaks near 62-64 GB; 10 would leave no room for the graph pools
DBRX_LAYERS = 8
DBRX_GATES = 2                 # vexp launches a layer: router, SwiGLU gate
# B2 / B7 at dbrx's decode shape: B 8, 48 query heads on 8 KV heads of
# 128 (G 6: the eight-row tier, six rows chained), a 2,048-token cache,
# page 64
DBRX_DECODE_SHAPE = dict(b=8, s=PHI3_MAX_SEQ, h=48, hkv=8, d=128,
                         page=PHI3_PAGE, full=1)
# dbrx's cuda tier against its reference tier over a teacher-forced
# replay (PHI3_TIER_STEPS forced steps, 2 requests a group, each at its
# wave's width), as phi3's: max |cuda - reference| <= DBRX_TIER_LIMIT[exp]
# x max |logit|. The gap is bimodal: where the two tiers route every
# token alike it is ~1 % of max |logit|, and one routing flip (a token's
# expert set changed by the tiers' rounding at a near tie) moves it to
# 10-30 %. Twice the JAX package's own pallas-vs-reference gap at dbrx's
# shape (tools/tier_gap.py --arch dbrx-132b --width narrow: 16 experts,
# top-4, G 6, head dim 128, d 768, prompts of 300 and 1,000 tokens, 16
# forced steps), the largest read at 2, 4 and 8 layers (0.1663 / 0.1735
# / 0.1441 of max |logit| under exact / vexp / vexp_hw; at 8 layers
# 0.1181 / 0.1171 / 0.1004): the flips' jumps do not grow with depth, so
# they are carried to 8 layers as read. The reduced width's 4 experts,
# top-2 (0.0085-0.3036) are not dbrx's routing and are not used.
DBRX_TIER_LIMIT = {"exact": 0.3326, "vexp": 0.3470, "vexp_hw": 0.2882}


def dbrx_setup():
    """dbrx-132b at full width, depth cut to DBRX_LAYERS (d 6144, 48
    heads on 8 KV heads of 128, 16 SwiGLU experts of d_ff 10752 a layer,
    4 taken a token, untied vocab 100,352), random weights drawn on the
    card from ``torch.Generator("cuda").manual_seed(0)`` (each expert
    matrix drawn in f32 and held in bf16, one at a time), its default
    policy (the cuda tier) and the three policy groups."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.runtime import parse_policy_groups, resolve_policy
    cfg = dataclasses.replace(get_config(DBRX_ARCH), n_layers=DBRX_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    policy = resolve_policy(cfg, env={})
    if policy.kernel_backend != "cuda":
        fail(f"dbrx: default tier is {policy.kernel_backend}, not cuda")
    groups = parse_policy_groups("eval=exact,bulk=vexp,hw=vexp_hw", cfg,
                                 base=policy)
    emit({"phase": "dbrx_setup", "n_layers": cfg.n_layers,
          "cut_from_layers": get_config(DBRX_ARCH).n_layers,
          "parameters": sum(p.numel() for p in params.parameters()),
          "weight_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
          "init_peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return cfg, params, policy, groups


# the edges of B2 / B7 at dbrx's phase: the eight-row tier's bounds at
# head dim 128 (G 5 and 8) and their neighbours (G 4 is phi3's, G 9 the
# sixteen-row path's), dbrx's G 6 also through pages of 128 keys
DBRX_EDGE_GROUPS = (5, 6, 8, 9)


def phase_dbrx_kernels(policy_cls):
    """B3, B2 and B7 at dbrx-132b's shapes (head dim 128, 48 query heads
    on 8 KV heads, G 6; ``d128_kernel_rows``): FA's admission wave (B 8,
    S 1024, ragged kv_len) and its edges, B2 ("bshd", the serve's
    layout) and B7 through a page-64 table, and both at their edges at
    G 5, 6, 8 and 9 (B7 at G 6 also through pages of 128 keys). Returns
    the rows 3d, 4d and 7d."""
    return d128_kernel_rows(policy_cls, DBRX_ARCH, d128_fa_inputs(48, 8, 31),
                            DBRX_DECODE_SHAPE, "d128g6", 32,
                            "dbrx_attention_kernels",
                            edge_groups=DBRX_EDGE_GROUPS,
                            page128_groups=(6,), bhsd=False, chunk=False)


class RouteLog:
    """While active, every routing decision of ``models.moe`` (the
    experts ``top_k`` picks for each token, a layer at a time) is kept on
    the card in call order, with no host sync."""

    def __init__(self):
        from repro_torch.models import moe as mod
        self.mod, self.calls = mod, []

    def __enter__(self):
        self.orig = self.mod.top_k
        self.mod.top_k = self.picked
        return self

    def __exit__(self, *exc):
        self.mod.top_k = self.orig
        return False

    def picked(self, probs, k):
        vals, idx = self.orig(probs, k)
        self.calls.append(torch.sort(idx, dim=-1).values)
        return vals, idx

    def flips(self, other, real):
        """(decisions whose expert set differs from ``other``'s, all
        decisions) over the real tokens: one decision a token a layer,
        the two logs' calls taken in order, a prefill's positions from
        ``real`` on (the pads, which route last and displace no real
        token) left out."""
        if len(self.calls) != len(other.calls):
            fail(f"routing logs of {len(self.calls)} and "
                 f"{len(other.calls)} calls")
        pairs = [(a[:, :real], b[:, :real])
                 for a, b in zip(self.calls, other.calls)]
        return (sum(int((a != b).any(-1).sum()) for a, b in pairs),
                sum(a[..., 0].numel() for a, _ in pairs))


def phase_serve_dbrx(kernels, smi, cfg, params, policy, groups):
    """dbrx-132b (8 layers, full width) through the port's Server on
    phi3's request mix: max_batch 8, max_seq 2,048, 16 requests with
    prompts in [32, 1024] (seed 0), 64 new tokens, groups eval=exact,
    bulk=vexp, hw=vexp_hw; the graph arm, then one eager arm (tokens
    equal), the capture audit, the decode step's graph ms and kernels per
    group against its weight-read bound, and a teacher-forced replay of
    2 requests a group whose every router and gate exp is held to its
    plain version (GateCheck) and whose cuda-tier logits are held to the
    reference tier's within DBRX_TIER_LIMIT, with the routing decisions
    that differ between the tiers counted. Returns {path: launch
    counts}."""

    def server(cuda_graphs=True):
        return phi3_server(cfg, params, policy, groups, cuda_graphs)

    t0 = time.perf_counter()
    for arm in ARMS:                     # warm-up, not measured
        srv = server(arm == "graph")
        srv.run(phi3_requests(cfg, groups, 3, 4, seed=1))
        del srv
    torch.cuda.synchronize()
    secs = {"warm_up": time.perf_counter() - t0}
    runs = {arm: [phi3_serve_once(
        kernels, cfg, server, lambda: phi3_requests(cfg, groups), arm,
        "decode_attention", "decode_attention_paged",
        f"serve_dbrx ({arm} arm)", DBRX_GATES)] for arm in ARMS}
    compare = compare_arms(runs, "serve_dbrx")
    first = runs["graph"][0]
    reqs = first["reqs"]
    secs["arms"] = time.perf_counter() - t0 - sum(secs.values())
    audits = capture_audits(cfg, server, lambda: phi3_requests(
        cfg, groups, 6, 8, seed=3), "serve_dbrx")
    srv = ssm_live_server(server, phi3_requests(cfg, groups, max_new=8,
                                                seed=3))
    steps = ssm_step_readings(srv)
    for name, b in phi3_step_bound(cfg, params, srv).items():
        steps[name].update(b)
        steps[name]["launches_per_step"] = dict(
            srv._groups[name].state.graph.launches)
    del srv
    gc.collect()
    secs["audit_and_step"] = time.perf_counter() - t0 - sum(secs.values())
    # each request replayed alone at the width of the wave that admitted
    # it: an expert's capacity is a function of the prefill's width, so
    # only there is the replay's prefill the serve's
    gates, tiers = GateCheck(), {}
    for name, pol in groups.items():
        rows = []
        for r in [r for r in reqs if r.group == name][:2]:
            with gates, RouteLog() as fast_routes:
                fast = replay_logits(cfg, params, [r], pol, PHI3_TIER_STEPS,
                                     r.admit_width)
            with RouteLog() as ref_routes:
                ref = replay_logits(cfg, params, [r],
                                    pol.replace(kernel_backend="reference"),
                                    PHI3_TIER_STEPS, r.admit_width)
            top = max(float(lg[:, :cfg.vocab].abs().max()) for lg in ref)
            limit = DBRX_TIER_LIMIT[pol.exp_backend] * top
            rows.append({"rid": r.rid, "max_abs_logit": top, "limit": limit,
                         "max_abs_diff": check_replay(f"dbrx {name}", [r],
                                                      fast, ref, limit)})
            rows[-1]["routing_flips"], rows[-1]["routing_decisions"] = \
                fast_routes.flips(ref_routes, len(r.prompt))
        tiers[name] = rows
    secs["replays"] = time.perf_counter() - t0 - sum(secs.values())
    emit({"phase": "serve_dbrx", "arch": cfg.arch_id,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
          "head_dim": cfg.hd, "d_ff": cfg.d_ff, "experts": cfg.n_experts,
          "top_k": cfg.top_k, "vocab_padded": cfg.vocab_padded,
          "arm": "graph", **first["readings"],
          "prompt_lens": [len(r.prompt) for r in reqs],
          "turns": {arm: [t["readings"] for t in runs[arm]] for arm in ARMS},
          "graph_vs_eager_tokens": compare, "capture_audit": audits,
          "step_graph": steps, "tier_max_abs_logit_diff": tiers,
          "gate_exps_checked": dict(gates.calls),
          "gate_exp_max_ulp": gates.max_ulp, "phase_seconds": secs,
          "nvidia_smi": smi})
    return {"serve_dbrx": first["counts"],
            "serve_dbrx_eager": runs["eager"][0]["counts"]}



# ------------------------------------------------ the sliding-window family

DANUBE_ARCH = "h2o-danube3-4b"
DANUBE_WINDOW = 4096           # the config's sliding window: the ring
# max_seq past the window: each group's pool is a full-window ring of
# 4,096 slots (Server's cache_s = min(max_seq, window)), which decodes
# without bound, so a request at the window wraps it on its first step
DANUBE_MAX_SEQ = 8192
DANUBE_PROMPT = (32, DANUBE_WINDOW)
DANUBE_REQUESTS = 12           # 4 a group, the first of each at the window
DANUBE_BATCH = 4               # a group's requests admitted in one wave
DANUBE_PAGE = 64               # a ring table of 64 pages a slot
# B2 / B7 at danube's decode shape: B 8, 32 query heads on 8 KV heads of
# 120 (G 4: the four-row tier, on the D 128 instantiation with columns
# 120-127 zero-filled), a 4,096-slot ring, page 64
DANUBE_DECODE_SHAPE = dict(b=8, s=DANUBE_WINDOW, h=32, hkv=8, d=120,
                           page=DANUBE_PAGE, full=1)
# the edges at head dim 120: G 1 and 4 (the four-row tier), 5 (the
# eight-row tier's first) and 16 (the sixteen-row path); cache_len from
# one key to the whole ring
DANUBE_EDGE_GROUPS = (1, 4, 5, 16)
DANUBE_EDGE_LENS = (1, 64, 65, 511, 512, 513, 2048, 4095, 4096)
# danube's cuda tier against its reference tier over a teacher-forced
# replay of each group's 4,096-token request (PHI3_TIER_STEPS forced
# steps, every one past the ring's wrap), as phi3's: max |cuda -
# reference| <= DANUBE_TIER_LIMIT[exp] x max |logit|. Twice the JAX
# package's own pallas-vs-reference gap under this check's conditions
# (tools/tier_gap.py --arch h2o-danube3-4b --width full: danube's
# widths, prompts of 1,000 and 4,096 tokens, 16 forced steps) read at 2
# and 4 layers (0.01103 / 0.01108 / 0.01319 and 0.01236 / 0.01245 /
# 0.01384 of max |logit| under exact / vexp / vexp_hw) and carried to
# 24 by the power law the two readings fit (powers 0.16 / 0.17 / 0.07:
# 0.01657 / 0.01686 / 0.01566 at 24).
DANUBE_TIER_LIMIT = {"exact": 0.0331, "vexp": 0.0337, "vexp_hw": 0.0313}


def phase_danube_kernels(policy_cls):
    """B3, B2 and B7 at h2o-danube3-4b's shapes (head dim 120, 32 query
    heads on 8 KV heads, G 4; ``d128_kernel_rows`` on the D 128 kernels
    with columns 120-127 zero-filled): FA's admission wave (B 8, S 4,096,
    ragged kv_len, causal, the 4,096 window; no float64 truth: its score
    matrix would not fit) and the same under a window of 700, and its
    edges (Sq 1,021 and 61, block_k 128 and the largest the card admits;
    the ~33 ms wave timed over 5 calls; no per-kernel µs of B2 / B7,
    ~3 s a case);
    B2 on a 4,096-slot ring in both layouts and B7 through a page-64 ring
    table in random order; both at their edges at G 1, 4, 5 and 16,
    cache_len 1 to 4,096, a window of 700 or none, B7 at G 4 also
    through pages of 128 keys. Returns the rows 3w, 4w and 7w."""
    return d128_kernel_rows(
        policy_cls, DANUBE_ARCH,
        d128_fa_inputs(32, 8, 41, d=120, sq=DANUBE_WINDOW, s=DANUBE_WINDOW),
        DANUBE_DECODE_SHAPE, "d120", 42, "danube_attention_kernels",
        edge_groups=DANUBE_EDGE_GROUPS, page128_groups=(4,), chunk=False,
        fa_window=DANUBE_WINDOW, fa_truth=False, cut_window=700,
        edge_lens=DANUBE_EDGE_LENS, fa_iters=5, decode_stages=False)


def danube_setup():
    """Full-width h2o-danube3-4b, all 24 layers (d 3840, 32 heads on 8 KV
    heads of 120, SwiGLU d_ff 10,240, untied vocab 32,000, window 4,096),
    random weights drawn on the card from ``torch.Generator("cuda")
    .manual_seed(0)``, its default policy (the cuda tier) and the three
    policy groups."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.runtime import parse_policy_groups, resolve_policy
    cfg = get_config(DANUBE_ARCH)
    if cfg.sliding_window != DANUBE_WINDOW or cfg.hd != 120:
        fail(f"danube: window {cfg.sliding_window}, head dim {cfg.hd}")
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    policy = resolve_policy(cfg, env={})
    if policy.kernel_backend != "cuda":
        fail(f"danube: default tier is {policy.kernel_backend}, not cuda")
    groups = parse_policy_groups("eval=exact,bulk=vexp,hw=vexp_hw", cfg,
                                 base=policy)
    emit({"phase": "danube_setup", "n_layers": cfg.n_layers,
          "parameters": sum(p.numel() for p in params.parameters()),
          "weight_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
          "init_peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return cfg, params, policy, groups


def danube_requests(cfg, groups, n=DANUBE_REQUESTS, max_new=64, seed=0):
    """``n`` requests with prompts in DANUBE_PROMPT from ``seed``, groups
    round-robin; the first request of each group is exactly the window
    long, so its decode runs past the ring's wrap from its first step."""
    from repro_torch.launch.serve import make_requests
    lo, hi = DANUBE_PROMPT
    reqs = make_requests(cfg, n, hi, max_new, mixed_lengths=True,
                         min_len=lo, groups=sorted(groups), seed=seed)
    rng = np.random.default_rng(seed + 1000)
    for r in reqs[:len(groups)]:
        r.prompt = rng.integers(0, cfg.vocab, (hi,), dtype=np.int32)
    return reqs


def danube_server(cfg, params, policy, groups, cuda_graphs=True,
                  paged=False):
    """max_batch 4, max_seq 8,192: each group's pool a full-window ring
    (contiguous: 1.5 GB; paged: 64-page ring tables, no prefix cache)."""
    from repro_torch.launch.serve import Server
    return Server(cfg, params, max_batch=DANUBE_BATCH,
                  max_seq=DANUBE_MAX_SEQ, policy=policy,
                  policy_groups=groups, device="cuda",
                  cuda_graphs=cuda_graphs, paged=paged)


def steps_past_window(reqs):
    """Decode steps taken at positions at or past the window: a
    request's steps write positions plen .. plen + emitted - 2."""
    return sum(max(0, len(r.prompt) + len(r.out) - 1
                   - max(len(r.prompt), DANUBE_WINDOW)) for r in reqs)


def phase_serve_danube(kernels, smi, cfg, params, policy, groups):
    """Full-width h2o-danube3-4b through the port's Server on its rings:
    max_batch 4, max_seq 8,192 (a 4,096-slot ring a slot), 12 requests,
    4 a group, with prompts in [32, 4,096] and one a group exactly 4,096
    long (seed 0), 64 new tokens, groups eval=exact, bulk=vexp,
    hw=vexp_hw; the graph arm, then the eager arm (tokens equal), the
    decode steps taken past the window counted (the run fails at 0), the
    capture audit, the decode step's graph ms and kernels per group
    against its bound, and a teacher-forced replay of each group's
    4,096-token request whose every SwiGLU gate exp is held to its plain
    version (GateCheck) and whose cuda-tier logits are held to the
    reference tier's within DANUBE_TIER_LIMIT. Returns ({path: launch
    counts}, the graph arm's requests)."""

    def server(cuda_graphs=True):
        return danube_server(cfg, params, policy, groups, cuda_graphs)

    t0 = time.perf_counter()
    server().run(danube_requests(cfg, groups, 3, 4, seed=1))   # warm-up
    torch.cuda.synchronize()
    secs = {"warm_up": time.perf_counter() - t0}
    runs = {arm: [phi3_serve_once(
        kernels, cfg, server, lambda: danube_requests(cfg, groups), arm,
        "decode_attention", "decode_attention_paged",
        f"serve_danube ({arm} arm)")] for arm in ARMS}
    compare = compare_arms(runs, "serve_danube")
    first = runs["graph"][0]
    reqs = first["reqs"]
    wrapped = steps_past_window(reqs)
    per_group = {name: steps_past_window([r for r in reqs
                                          if r.group == name])
                 for name in groups}
    if min(per_group.values()) == 0:
        fail(f"serve_danube: decode steps past position {DANUBE_WINDOW} "
             f"per group {per_group}: a group's ring never wrapped")
    secs["arms"] = time.perf_counter() - t0 - sum(secs.values())
    audits = capture_audits(cfg, server, lambda: danube_requests(
        cfg, groups, 6, 8, seed=3), "serve_danube")
    srv = ssm_live_server(server, danube_requests(cfg, groups, max_new=8,
                                                  seed=3))
    steps = ssm_step_readings(srv)
    for name, b in phi3_step_bound(cfg, params, srv).items():
        steps[name].update(b)
        steps[name]["launches_per_step"] = dict(
            srv._groups[name].state.graph.launches)
    del srv
    gc.collect()
    secs["audit_and_step"] = time.perf_counter() - t0 - sum(secs.values())
    gates, tiers = GateCheck(), {}
    for name, pol in groups.items():
        one = [r for r in reqs if r.group == name
               and len(r.prompt) == DANUBE_WINDOW][:1]
        with gates:
            fast = replay_logits(cfg, params, one, pol, PHI3_TIER_STEPS)
        ref = replay_logits(cfg, params, one,
                            pol.replace(kernel_backend="reference"),
                            PHI3_TIER_STEPS)
        top = max(float(lg[:, :cfg.vocab].abs().max()) for lg in ref)
        limit = DANUBE_TIER_LIMIT[pol.exp_backend] * top
        tiers[name] = {"rid": one[0].rid,
                       "max_abs_diff": check_replay(f"danube {name}", one,
                                                    fast, ref, limit),
                       "max_abs_logit": top, "limit": limit}
    secs["replays"] = time.perf_counter() - t0 - sum(secs.values())
    emit({"phase": "serve_danube", "arch": cfg.arch_id,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
          "head_dim": cfg.hd, "d_ff": cfg.d_ff, "window": DANUBE_WINDOW,
          "vocab_padded": cfg.vocab_padded, "arm": "graph",
          **first["readings"], "prompt_lens": [len(r.prompt) for r in reqs],
          "decode_steps_past_window": wrapped,
          "decode_steps_past_window_by_group": per_group,
          "turns": {arm: [t["readings"] for t in runs[arm]] for arm in ARMS},
          "graph_vs_eager_tokens": compare, "capture_audit": audits,
          "step_graph": steps, "tier_max_abs_logit_diff": tiers,
          "gate_exps_checked": dict(gates.calls),
          "gate_exp_max_ulp": gates.max_ulp, "phase_seconds": secs,
          "nvidia_smi": smi})
    return ({"serve_danube": first["counts"],
             "serve_danube_eager": runs["eager"][0]["counts"]}, reqs)


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
    del params
    gc.collect()
    torch.cuda.empty_cache()
    train_rows = phase_train_kernels(ExecPolicy)
    rows[0]["train"] = train_rows["vexp"]
    rows[2]["train"] = train_rows["flash_attention"]
    by_path["train_gpt2"] = phase_train_gpt2(kernels, smi)
    cfg, params, policy, groups = ssm_setup()
    ssm_counts, ssm_mono = phase_serve_ssm(kernels, smi, cfg, params, policy,
                                           groups)
    by_path.update(ssm_counts)
    by_path.update(phase_serve_ssm_chunked(kernels, smi, cfg, params, policy,
                                           groups, ssm_mono))
    by_path.update(phase_serve_ssm_spec(kernels, smi, cfg, params, policy,
                                        groups, ssm_mono))
    del params
    torch.cuda.empty_cache()
    hyb_rows = phase_hybrid_kernels(ExecPolicy)
    for row in rows[2:5]:
        row["d256"] = hyb_rows[row["name"]]
    cfg, params, policy, groups = hybrid_setup()
    hyb_counts, hyb_mono = phase_serve_hybrid(kernels, smi, cfg, params,
                                              policy, groups)
    by_path.update(hyb_counts)
    paged_counts, hyb_paged = phase_serve_hybrid_paged(
        kernels, smi, cfg, params, policy, groups, hyb_mono)
    by_path.update(paged_counts)
    by_path.update(phase_serve_hybrid_chunked(kernels, smi, cfg, params,
                                              policy, groups, hyb_mono))
    by_path.update(phase_serve_hybrid_spec(kernels, smi, cfg, params,
                                           policy, groups, hyb_mono,
                                           hyb_paged))
    del params
    torch.cuda.empty_cache()
    phi3_rows = phase_phi3_kernels(ExecPolicy)
    for row in rows[2:5]:
        row["d128"] = phi3_rows[row["name"]]
    cfg, params, policy, groups = phi3_setup()
    phi3_counts, phi3_mono = phase_serve_phi3(kernels, smi, cfg, params,
                                              policy, groups)
    by_path.update(phi3_counts)
    by_path.update(phase_serve_phi3_paged(kernels, smi, cfg, params, policy,
                                          groups, phi3_mono))
    by_path.update(phase_serve_phi3_chunked(kernels, smi, cfg, params,
                                            policy, groups, phi3_mono))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dbrx_rows = phase_dbrx_kernels(ExecPolicy)
    for row in rows[2:5]:
        row["d128g6"] = dbrx_rows[row["name"]]
    cfg, params, policy, groups = dbrx_setup()
    by_path.update(phase_serve_dbrx(kernels, smi, cfg, params, policy,
                                    groups))
    by_path.update(phase_serve_phi3_paged(kernels, smi, cfg, params, policy,
                                          groups, None, "dbrx", DBRX_GATES))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    danube_rows = phase_danube_kernels(ExecPolicy)
    for row in rows[2:5]:
        row["d120"] = danube_rows[row["name"]]
    cfg, params, policy, groups = danube_setup()
    danube_counts, _ = phase_serve_danube(kernels, smi, cfg, params, policy,
                                          groups)
    by_path.update(danube_counts)
    by_path.update(phase_serve_phi3_paged(
        kernels, smi, cfg, params, policy, groups, None, "danube",
        make_server=danube_server, make_requests=danube_requests,
        page=DANUBE_PAGE))
    for row, name in zip(rows, ("vexp", "softmax", "flash_attention",
                                "decode_attention",
                                "decode_attention_paged",
                                "decode_attention_partial",
                                "decode_attention_packed",
                                "decode_attention_paged_partial",
                                "decode_attention_paged_packed")):
        row["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if "d120" in row:            # danube's share, its serve paths'
            row["d120"]["launches"] = sum(
                n for p, n in row["launches_by_path"].items()
                if p.startswith("serve_danube"))
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
