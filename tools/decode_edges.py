"""B2 and B7 at their edge cases at head dim 128, printed, not checked.

Runs ``chip_smoke.py``'s ``_decode_edges(d=128)`` (G 1, 5 and 16 on one
KV head, cache_len at the tile and block bounds, a window of 700, B7
through a page-64 table and, at G 4, through pages of 128 keys; with
``--dbrx`` G 5, 6, 8 and 9, and G 6 through pages of 128 keys, as
``phase_dbrx_kernels`` runs them) with the kernels of TREE, built from
TREE's own sources, and prints one JSON line per case: each exp
backend's kernel reading and negative controls against the plain
version, as [max_abs_err, mismatch_share, "ok" or "BAD"] under
``ATT_LIMITS``; then the count of BAD readings. With TREE
another checkout (say, a commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists), it shows whether that tree's
kernels pass the edge cases of this checkout's ``chip_smoke.py``.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/decode_edges.py [--dbrx] [TREE]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    dbrx = "--dbrx" in sys.argv[1:]
    args = [a for a in sys.argv[1:] if a != "--dbrx"]
    tree = Path(args[0] if args else ROOT).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch
    import chip_smoke
    from repro_torch.kernels import build, decode_attention as da
    from repro_torch.kernels.limits import ATT_LIMITS
    from repro_torch.runtime import ExecPolicy
    if not torch.cuda.is_available():
        sys.exit("[decode_edges] no CUDA device")
    if Path(da.__file__).resolve().parents[3] != tree:
        sys.exit(f"[decode_edges] imported {da.__file__}, not {tree}")
    build.build_all(["decode_attention.cu", "decode_attention_paged.cu"])
    if dbrx:
        _, rds = chip_smoke._decode_edges(
            da, ExecPolicy, d=128, seed=35,
            groups=chip_smoke.DBRX_EDGE_GROUPS, page128_groups=(6,))
    else:
        _, rds = chip_smoke._decode_edges(da, ExecPolicy, d=128, seed=25,
                                          page128_groups=(4,))
    bad = 0
    for tag, kernel, rd in rds:
        row = {}
        for (exp, who), (err, share) in rd.items():
            lim_err, lim_share = ATT_LIMITS[kernel][exp]
            inside = err <= lim_err and share <= lim_share
            ok = inside if who == "kernel" else not inside
            bad += not ok
            row[f"{exp}_{who}"] = [err, share, "ok" if ok else "BAD"]
        print(json.dumps({"tree": str(tree), "tag": tag, **row}),
              flush=True)
    print(json.dumps({"tree": str(tree), "bad": bad}), flush=True)


if __name__ == "__main__":
    main()
