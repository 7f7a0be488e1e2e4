"""Where the FlashAttention kernel's time goes, on the card.

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` with parts of
the work cut out (their outputs are wrong; only their times count) and
times each at ``chip_smoke.py``'s cold FA shape (B=8, H=12, D=64,
S=512, ragged kv_len, causal, block_k 512) as a CUDA graph of
back-to-back calls, under the exact exp and under vexp. The difference
between a cut and the full kernel is what that part costs where nothing
else hides it.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/fa_ablation.py

It prints one JSON line per variant and exits non-zero if a cut no longer
matches the source (the source changed under it).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_graph_time_ms  # noqa: E402
from repro_torch.kernels import build, flash_attention as fa  # noqa: E402
from repro_torch.runtime import ExecPolicy  # noqa: E402

SCORES = ("for (int d = 0; d < D; ++d) {", "for (int d = 0; d < 1; ++d) {")
PV = ("for (int c = 0; c < kTK; ++c) {", "for (int c = 0; c < 1; ++c) {")
EXP = ("vexp::apply_exp(BACKEND, __fsub_rn(sr[i], m_new[i]))",
       "__fsub_rn(sr[i], m_new[i])")
WIDEN = [("      widen_k<D>(rt, sT);\n", ""),
         ("      widen_v<D>(rt, sT);\n", "")]
# variant -> text replacements in the source
CUTS = {
    "full": [],
    "no_score_fma": [SCORES],
    "no_pv_fma": [PV],
    "no_p_exp": [EXP],
    "no_widen": WIDEN,
    "no_fma": [SCORES, PV],
    "no_fma_no_exp": [SCORES, PV, EXP],
    "skeleton": [SCORES, PV, EXP] + WIDEN,
}


def build_variants(out_dir: Path) -> dict:
    src = (build.CSRC / "flash_attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                sys.exit(f"[fa_ablation] {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"[fa_ablation] nvcc failed on {name}:\n{out}")
    return {name: out_dir / f"{name}.so" for name in CUTS}


def main():
    if not torch.cuda.is_available():
        sys.exit("[fa_ablation] no CUDA device")
    libs = build_variants(ROOT / "build" / "fa_ablation")
    g = torch.Generator(device="cuda").manual_seed(1)
    b, s, h, d = 8, 512, 12, 64
    q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    kv_len = torch.randint(32, s + 1, (b,), generator=g, device="cuda",
                           dtype=torch.int32)
    kv_len[0] = s
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for name, path in libs.items():
        fa.LIB._lib = ctypes.CDLL(os.fspath(path))
        fa.LIB._fns = {}
        row = {"variant": name, "nvidia_smi": smi}
        for exp in ("exact", "vexp"):
            pol = ExecPolicy(exp_backend=exp, block_k=512)
            row[f"graph_ms_{exp}"] = cuda_graph_time_ms(
                lambda: fa.flash_attention(q, k, v, causal=True,
                                           kv_len=kv_len, policy=pol))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
