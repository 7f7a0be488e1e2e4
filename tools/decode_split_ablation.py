"""Where the head-dim-256 flash-decode sweep's time goes, on the card.

Builds copies of ``src/repro_torch/csrc/decode_attention.cu`` and
``decode_attention_paged.cu`` whose ``decode_split.cuh`` has parts of the
D = 256 path cut out (their outputs are wrong; only their times count),
and times each at ``chip_smoke.py``'s B2 / B7 shape
(``hybrid_decode_inputs``: B 8, 16 query heads on one KV head, a
2048-slot ring, block_s 512 or page 64) under vexp, as a CUDA graph of
back-to-back calls and per CUDA kernel (torch.profiler). The difference
between a cut and the full kernel is what that part costs where nothing
else hides it.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/decode_split_ablation.py [--phi3 | --dbrx]

With ``--phi3`` the variants run at phi3-medium-14b's decode shape
instead (``PHI3_DECODE_SHAPE``: B 8, 40 query heads on 10 KV heads of
128, a 2,048-token cache, block_s 512 or page 64), with the cuts of the
four- and eight-row stage 2 (``split_pv_rows``); with ``--dbrx`` at
dbrx-132b's (``DBRX_DECODE_SHAPE``: B 8, 48 query heads on 8 KV heads of
128, G 6, a 2,048-token cache, block_s 512 or page 64), with those cuts
and the eight-row tier's design candidates: eight rows chained at G 6
(``r8_at_g6``; the source chains six), the chain's unroll at 4 and 16
keys (the source loads 8), stage 1 without its skip of the rows past G
(``s1_no_skip``) and stage 2 held to three CTAs an SM
(``s2_three_ctas``).

It prints one JSON line per variant (each timed in a process of its own)
and exits non-zero if a cut no longer matches the source (the source
changed under it).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (DBRX_DECODE_SHAPE, PHI3_DECODE_SHAPE,  # noqa: E402
                        PHI3_PAGE, cuda_graph_time_ms, decode_inputs,
                        hybrid_decode_inputs, stage_device_us)
from repro_torch.kernels import build, decode_attention as da  # noqa: E402
from repro_torch.runtime import ExecPolicy  # noqa: E402

SOURCES = {"decode_attention.cu": da.LIB,
           "decode_attention_paged.cu": da.PAGED_LIB}
# stage 1: the score chains, q into shared memory, the K rows' copy
S1_FMA = ("#pragma unroll 2\n  for (int v8 = 0; v8 < D / 8; ++v8) {",
          "#pragma unroll 2\n  for (int v8 = 0; v8 < 1; ++v8) {")
S1_Q = ("for (int i = tid; i < G * D; i += kScoreThreads)",
        "for (int i = tid; i < 0; i += kScoreThreads)")
S1_K = ("  load_rows<D, PAGED, kScoreThreads>(a, a.k, b, h, phys, x, sK, "
        "PITCH, DV);\n", "")
# stage 2: the exps, the p @ v and l chains, the V copies
S2_EXP = ("const float e = exp_as<BK>(__fsub_rn(sv[u], m));",
          "const float e = __fsub_rn(sv[u], m);")
S2_CHAIN = [("for (; c + kUnroll <= c1; c += kUnroll) {",
             "for (; c + kUnroll <= c0; c += kUnroll) {"),
            ("  for (; c < c1; ++c)\n    chain_key<WITH_L>(",
             "  for (; c < c0; ++c)\n    chain_key<WITH_L>(")]
S2_V = ("        load_rows<SC, PAGED, kPvThreads>(\n",
        "        if (false) load_rows<SC, PAGED, kPvThreads>(\n")
S2_V0 = ("      load_rows<SC, PAGED, kPvThreads>(\n",
         "      if (false) load_rows<SC, PAGED, kPvThreads>(\n")
# stage 3's chain over the blocks, and the dependent launch
S3 = ("for (int j0 = j_first; j0 < j_last; j0 += kBatch) {",
      "for (int j0 = j_first; j0 < j_first; j0 += kBatch) {")
# the four- and eight-row stage 2 at D 128 (split_pv_rows): its V copies,
# its exps, its p @ v and l chains, its wait for stage 1
R4_V0 = ("    load_rows<D, PAGED, kRowsThreads>(\n        a, a.v, b, h, "
         "page_of<PAGED>(a, b, t_lo + u),",
         "    if (false) load_rows<D, PAGED, kRowsThreads>(\n        a, a.v, "
         "b, h, page_of<PAGED>(a, b, t_lo + u),")
R4_V = ("      load_rows<D, PAGED, kRowsThreads>(\n          a, a.v, b, h, "
        "page_of<PAGED>(a, b, tt - 1 + nbuf),",
        "      if (false) load_rows<D, PAGED, kRowsThreads>(\n          a, "
        "a.v, b, h, page_of<PAGED>(a, b, tt - 1 + nbuf),")
R4_CHAIN = [("  for (; c + U <= c1; c += U) {",
             "  for (; c + U <= c0; c += U) {"),
            ("  for (; c < c1; ++c) {\n    float p[R];",
             "  for (; c < c0; ++c) {\n    float p[R];")]
R4_EXP = ("const float ex = exp_as<BK>(__fsub_rn(sv[u], m));",
          "const float ex = __fsub_rn(sv[u], m);")
R4_L = ("      for (int c = c0; c < c1; ++c) lsum = __fadd_rn(lsum, pl[c * PS]);",
        "      for (int c = c0; c < c0; ++c) lsum = __fadd_rn(lsum, pl[c * PS]);")
R4_WAIT = ("  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
           "  const int t_mid = j * a.tpb, t_end = t_mid + a.tpb;\n"
           "  for (int g = warp; g < G; g += CW + 1) {",
           "  const int t_mid = j * a.tpb, t_end = t_mid + a.tpb;\n"
           "  for (int g = warp; g < G; g += CW + 1) {")
NO_PDL = ("  cfg.numAttrs = pdl ? 1 : 0;\n", "  cfg.numAttrs = 0;\n")
ALL_PDL = ("  cfg.numAttrs = pdl ? 1 : 0;\n", "  cfg.numAttrs = 1;\n")
# variant -> text replacements in decode_split.cuh
CUTS = {
    "full": [],
    "s1_no_fma": [S1_FMA],
    "s1_no_q": [S1_Q],
    "s1_no_k": [S1_K],
    "s1_skeleton": [S1_FMA, S1_Q, S1_K],
    "s2_no_exp": [S2_EXP],
    "s2_no_chain": S2_CHAIN,
    "s2_no_v": [S2_V, S2_V0],
    "s2_skeleton": [S2_EXP, S2_V, S2_V0] + S2_CHAIN,
    "s3_no_combine": [S3],
    "no_pdl": [NO_PDL],
    "all_pdl": [ALL_PDL],
}
# the cuts of the G-4 path (``--phi3``): its stage 2's own chains, V
# copies and wait for stage 1 replace the D 256 path's stage-2 cuts
CUTS_G4 = {name: cuts for name, cuts in CUTS.items()
           if name not in ("s2_no_exp", "s2_no_chain", "s2_no_v",
                           "s2_skeleton")}
CUTS_G4.update({
    "s2_no_exp": [R4_EXP],
    "s2_no_chain": R4_CHAIN,
    "s2_no_l": [R4_L],
    "s2_no_v": [R4_V, R4_V0],
    "s2_skeleton": [R4_EXP, R4_V, R4_V0, R4_L] + R4_CHAIN,
    "s2_no_wait": [R4_WAIT],
})
# the eight-row tier's candidates (``--dbrx``)
R8_AT_G6 = ("constexpr int kChainG6 = 6;", "constexpr int kChainG6 = 0;")
R8_UNROLL = "constexpr int kRowsUnroll8 = 8;"
S1_NO_SKIP = ("  if constexpr (kMaxG == kChainG8) {",
              "  if constexpr (false) {")
S2_THREE_CTAS = ("__launch_bounds__(kRowsThreads) split_pv_rows",
                 "__launch_bounds__(kRowsThreads, 3) split_pv_rows")
CUTS_G8 = dict(CUTS_G4)
CUTS_G8.update({
    "r8_at_g6": [R8_AT_G6],
    "unroll4": [(R8_UNROLL, R8_UNROLL.replace("8;", "4;"))],
    "unroll16": [(R8_UNROLL, R8_UNROLL.replace("8;", "16;"))],
    "s1_no_skip": [S1_NO_SKIP],
    "s2_three_ctas": [S2_THREE_CTAS],
})


def build_variants(out_dir: Path, cuts_table: dict) -> dict:
    src = (build.CSRC / "decode_split.cuh").read_text()
    procs = {}
    for name, cuts in cuts_table.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                sys.exit(f"[decode_split_ablation] {name}: {old!r} is not "
                         f"once in decode_split.cuh")
            text = text.replace(old, new)
        vdir = out_dir / name
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "decode_split.cuh").write_text(text)
        for f in ("vexp.cuh",) + tuple(SOURCES):
            shutil.copy(build.CSRC / f, vdir / f)
        for cu in SOURCES:
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(vdir),
                   "-o", str(vdir / Path(cu).with_suffix(".so")),
                   str(vdir / cu)]
            procs[name, cu] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    for (name, cu), proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"[decode_split_ablation] nvcc failed on {name} "
                     f"{cu}:\n{out}")
    return {name: out_dir / name for name in cuts_table}


def time_variant(name: str, vdir: Path, shape: str):
    """One variant's times, in a process of its own (one build of the
    sources loaded per process), at ``shape``: "d256", "phi3" or
    "dbrx"."""
    for cu, lib in SOURCES.items():
        lib._lib = ctypes.CDLL(os.fspath(vdir / Path(cu).with_suffix(".so")))
        lib._fns = {}
    pol = ExecPolicy(exp_backend="vexp",
                     block_page=PHI3_PAGE if shape != "d256" else 64)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    row = {"variant": name, "nvidia_smi": smi}
    for paged in (False, True):
        if shape == "d256":
            *_, run = hybrid_decode_inputs(da, paged)
        elif shape == "phi3":
            *_, run = decode_inputs(da, paged, seed=22 + 2 * paged,
                                    **PHI3_DECODE_SHAPE)
        else:
            *_, run = decode_inputs(da, paged, seed=32 + 2 * paged,
                                    **DBRX_DECODE_SHAPE)
        tag = "paged" if paged else "contig"
        row[f"graph_ms_{tag}"] = cuda_graph_time_ms(lambda: run(pol),
                                                    iters=50)
        row[f"stage_us_{tag}"] = stage_device_us(lambda: run(pol))
    print(json.dumps(row), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("[decode_split_ablation] no CUDA device")
    out_dir = ROOT / "build" / "decode_split_ablation"
    flags = [a for a in sys.argv[1:] if a in ("--phi3", "--dbrx")]
    args = [a for a in sys.argv[1:] if a not in flags]
    shape = flags[0][2:] if flags else "d256"
    if len(args) == 2 and args[0] == "--variant":
        time_variant(args[1], out_dir / args[1], shape)
        return
    table = {"d256": CUTS, "phi3": CUTS_G4, "dbrx": CUTS_G8}[shape]
    build_variants(out_dir, table)
    failed = [name for name in table
              if subprocess.run([sys.executable, __file__, "--variant",
                                 name] + flags, cwd=ROOT).returncode != 0]
    if failed:
        sys.exit(f"[decode_split_ablation] failed: {failed}")


if __name__ == "__main__":
    main()
