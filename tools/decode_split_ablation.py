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

    python3 tools/decode_split_ablation.py

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

from chip_smoke import (cuda_graph_time_ms, hybrid_decode_inputs,  # noqa: E402
                        stage_device_us)
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
        "PITCH);\n", "")
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


def build_variants(out_dir: Path) -> dict:
    src = (build.CSRC / "decode_split.cuh").read_text()
    procs = {}
    for name, cuts in CUTS.items():
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
    return {name: out_dir / name for name in CUTS}


def time_variant(name: str, vdir: Path):
    """One variant's times, in a process of its own (one build of the
    sources loaded per process)."""
    for cu, lib in SOURCES.items():
        lib._lib = ctypes.CDLL(os.fspath(vdir / Path(cu).with_suffix(".so")))
        lib._fns = {}
    pol = ExecPolicy(exp_backend="vexp", block_page=64)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    row = {"variant": name, "nvidia_smi": smi}
    for paged in (False, True):
        *_, run = hybrid_decode_inputs(da, paged)
        tag = "paged" if paged else "contig"
        row[f"graph_ms_{tag}"] = cuda_graph_time_ms(lambda: run(pol),
                                                    iters=50)
        row[f"stage_us_{tag}"] = stage_device_us(lambda: run(pol))
    print(json.dumps(row), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("[decode_split_ablation] no CUDA device")
    out_dir = ROOT / "build" / "decode_split_ablation"
    if len(sys.argv) == 3 and sys.argv[1] == "--variant":
        time_variant(sys.argv[2], out_dir / sys.argv[2])
        return
    build_variants(out_dir)
    failed = [name for name in CUTS
              if subprocess.run([sys.executable, __file__, "--variant",
                                 name], cwd=ROOT).returncode != 0]
    if failed:
        sys.exit(f"[decode_split_ablation] failed: {failed}")


if __name__ == "__main__":
    main()
