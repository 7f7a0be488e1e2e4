"""Where the FlashAttention kernel's time goes, on the card.

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` with parts of
the work cut out (their outputs are wrong; only their times count) and
times each as a CUDA graph of back-to-back calls. The difference between
a cut and the full kernel is what that part costs where nothing else
hides it.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/fa_ablation.py
    python3 tools/fa_ablation.py --d256 [--parent DIR] [--cuts]
    python3 tools/fa_ablation.py --d128 [--parent DIR] [--cuts]

Without ``--d256``: the head-dim-64 path at ``chip_smoke.py``'s cold FA
shape (B=8, H=12, D=64, S=512, ragged kv_len, causal, block_k 512), under
the exact exp and vexp, every cut.

With ``--d256``: the head-dim-256 path at ``chip_smoke.py``'s hybrid
shapes (``hybrid_fa_inputs``: the wave, B 8 x 2048 queries of 16 heads on
one KV head, ragged kv_len, window 2048; the chunk, 256 queries at (B,)
offsets), block_k 512. The full kernel runs in turns, graph ms per exp
backend at both shapes; with ``--parent``, DIR is another checkout (say,
the parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), whose kernel is built from its own sources and
timed in turns with this tree's: parent, this, this, parent. With
``--cuts`` each cut of this tree's D 256 design is timed once more under
vexp. The cuts are written for the design the source holds (its marker
string picks the table): ``fa_rows`` here (its D 256 instance; the
earlier ``fa256`` kernel before its head dim became a template parameter
read the same cuts), and the earlier ``Tile<256>``
design (32-row tiles in the shared kernel) for a copy of this tool run
in a checkout that still holds it.

With ``--d128``: the same at phi3-medium-14b's shapes
(``phi3_fa_inputs``: the wave, B 8 x 1024 queries of 40 heads on 10 KV
heads, ragged kv_len, causal; the chunk, 256 queries at (B,) offsets over
2,048 keys), block_k 512, with the cuts of the design that holds head dim
128 in the source.

It prints one JSON line per reading and exits non-zero if a cut no
longer matches the source (the source changed under it).
"""

from __future__ import annotations

import argparse
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

import chip_smoke  # noqa: E402
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

# The D 256 cuts, per design: the marker string that names the design in
# the source, then variant -> replacements.
_L_CHAIN_21 = ("        if (tx < 4)\n          for (int c = 0; c < kTK; ++c)\n",
               "        if (false)\n          for (int c = 0; c < kTK; ++c)\n")
_COPY_21 = ("    cp_async16(dst + r * Smem<D>::kRowB + c * 8,\n"
            "               ok ? src + key * stride + c * 8 : src, "
            "ok ? 16 : 0);\n", "")
_SCORES_256 = ("  for (int d4 = 0; d4 < kSlabD / 4; ++d4) {",
               "  for (int d4 = 0; d4 < 1; ++d4) {")
_PV_256 = ("  for (int c = 0; c < Layout<kD>::kVKeys; ++c) {\n"
           "    float p[8], v[C];",
           "  for (int c = 0; c < 1; ++c) {\n    float p[8], v[C];")
_EXP_256 = ("      const float ex = vexp::apply_exp(BACKEND, "
            "__fsub_rn(sv[i], m[i]));",
            "      const float ex = __fsub_rn(sv[i], m[i]);")
_L_CHAIN_256 = ("    lch = __fadd_rn(lch, sp[c * kRows + lrow]);\n", "")
_WIDEN_256 = [("    widen8(st.w[n], f);\n",
               "    f[0] = f[1] = __uint_as_float(st.w[n].x);\n"
               "    f[2] = f[3] = __uint_as_float(st.w[n].y);\n"
               "    f[4] = f[5] = __uint_as_float(st.w[n].z);\n"
               "    f[6] = f[7] = __uint_as_float(st.w[n].w);\n")]
_COPY_256 = [
    ("    st.w[n] = r < nkeys && key < km &&\n",
     "    st.w[n] = false &&\n"),
    ("    st.w[n] = key < km && (!kNarrow<kD> || 8 * c < dv)\n",
     "    st.w[n] = false\n")]
CUTS_D256 = {
    # 64 (position, head) rows a CTA, 8 x 8 register tiles, K in 16-d
    # slabs and V in 16-key slabs widened to f32 through registers, l in
    # the p . v loop
    "fa_rows_kernel": {
        "no_score_fma": [_SCORES_256],
        "no_pv_fma": [_PV_256],
        "no_p_exp": [_EXP_256],
        "no_l_chain": [_L_CHAIN_256],
        "no_widen": _WIDEN_256,
        "no_copies": _COPY_256,
        "skeleton": [_SCORES_256, _PV_256, _EXP_256] + _COPY_256,
    },
    # the earlier Tile<256> in the shared kernel: 32-row query tiles,
    # 32-key sub-tiles, a widened f32 tile, l chained by four lanes a row
    # group
    "kChainL = D >= 256": {
        "no_score_fma": [SCORES],
        "no_pv_fma": [PV],
        "no_p_exp": [EXP],
        "no_l_chain": [_L_CHAIN_21],
        "no_widen": WIDEN,
        "no_copies": [_COPY_21],
        "skeleton": [SCORES, PV, EXP, _L_CHAIN_21, _COPY_21] + WIDEN,
    },
}

# The D 128 cuts, per design: fa_rows<128> shares fa_rows<256>'s source
# (its V slabs are whole 32-key groups), so its table is the same.
CUTS_D128 = {"fa_rows_kernel": CUTS_D256["fa_rows_kernel"]}


def _apply(src: str, cuts, name: str) -> str:
    for old, new in cuts:
        if old not in src:
            sys.exit(f"[fa_ablation] {name}: {old!r} not in the source")
        src = src.replace(old, new)
    return src


def build_variants(out_dir: Path, variants: dict) -> dict:
    """variants: name -> (source text, include dir). One nvcc each, all
    at once. Returns name -> library path."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, inc) in variants.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(inc),
               "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"[fa_ablation] nvcc failed on {name}:\n{out}")
        (out_dir / f"{name}.log").write_text(out)
    return {name: out_dir / f"{name}.so" for name in variants}


def use(path: Path):
    """Route the wrapper's launches to the library at ``path``."""
    fa.LIB._lib = ctypes.CDLL(os.fspath(path))
    fa.LIB._fns = {}
    fa._SMEM_OK.clear()


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main_d64():
    src = (build.CSRC / "flash_attention.cu").read_text()
    libs = build_variants(ROOT / "build" / "fa_ablation", {
        name: (_apply(src, cuts, name), build.CSRC)
        for name, cuts in CUTS.items()})
    g = torch.Generator(device="cuda").manual_seed(1)
    b, s, h, d = 8, 512, 12, 64
    q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    kv_len = torch.randint(32, s + 1, (b,), generator=g, device="cuda",
                           dtype=torch.int32)
    kv_len[0] = s
    smi = smi_line()
    for name, path in libs.items():
        use(path)
        row = {"variant": name, "nvidia_smi": smi}
        for exp in ("exact", "vexp"):
            pol = ExecPolicy(exp_backend=exp, block_k=512)
            row[f"graph_ms_{exp}"] = cuda_graph_time_ms(
                lambda: fa.flash_attention(q, k, v, causal=True,
                                           kv_len=kv_len, policy=pol))
        print(json.dumps(row), flush=True)


def rows_shapes(d: int) -> dict:
    """name -> run(policy): the wave and the chunk at head dim d (256:
    recurrentgemma's, 128: phi3-medium's)."""
    if d == 128:
        q, k, v, kv_len, qc, offs, clens = chip_smoke.phi3_fa_inputs()
        sq = q.shape[1]
        kw, vw = k[:, :sq], v[:, :sq]
        return {
            "wave": lambda pol: fa.flash_attention(
                q, kw, vw, causal=True, kv_len=kv_len, policy=pol),
            "chunk": lambda pol: fa.flash_attention(
                qc, k, v, causal=True, kv_len=offs + clens, q_offset=offs,
                policy=pol),
        }
    q, k, v, kv_len, qc, offs, clens = chip_smoke.hybrid_fa_inputs()
    win = chip_smoke.HYBRID_FA_WINDOW
    return {
        "wave": lambda pol: fa.flash_attention(
            q, k, v, causal=True, window=win, kv_len=kv_len, policy=pol),
        "chunk": lambda pol: fa.flash_attention(
            qc, k, v, causal=True, window=win, kv_len=offs + clens,
            q_offset=offs, policy=pol),
    }


def main_rows(d: int, parent: Path | None, cuts: bool):
    src = (build.CSRC / "flash_attention.cu").read_text()
    variants = {"this": (src, build.CSRC)}
    if parent is not None:
        pcsrc = parent / "src" / "repro_torch" / "csrc"
        variants["parent"] = ((pcsrc / "flash_attention.cu").read_text(),
                              pcsrc)
    if cuts:
        table = CUTS_D128 if d == 128 else CUTS_D256
        design = [m for m in table if m in src]
        if len(design) != 1:
            sys.exit(f"[fa_ablation] no D {d} cut table matches the source")
        for name, cut in table[design[0]].items():
            variants[name] = (_apply(src, cut, name), build.CSRC)
    libs = build_variants(ROOT / "build" / f"fa_ablation_d{d}", variants)
    shapes = rows_shapes(d)
    smi = smi_line()

    def reading(name, turn, exps):
        use(libs[name])
        row = {"variant": name, "turn": turn, "nvidia_smi": smi}
        for shape, run in shapes.items():
            for exp in exps:
                pol = ExecPolicy(exp_backend=exp, block_k=512)
                row[f"{shape}_graph_ms_{exp}"] = cuda_graph_time_ms(
                    lambda: run(pol))
        print(json.dumps(row), flush=True)

    order = (["parent", "this", "this", "parent"] if parent is not None
             else ["this", "this"])
    for turn, name in enumerate(order):
        reading(name, turn, ("exact", "vexp", "vexp_hw"))
    for name in variants:
        if name not in ("this", "parent"):
            reading(name, 0, ("vexp",))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d256", action="store_true")
    ap.add_argument("--d128", action="store_true")
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--cuts", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("[fa_ablation] no CUDA device")
    if args.d256 or args.d128:
        main_rows(128 if args.d128 else 256, args.parent, args.cuts)
    else:
        main_d64()


if __name__ == "__main__":
    main()
