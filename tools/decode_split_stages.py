"""Where the chained flash-decode sweep's time goes, on the card.

Runs ``chip_smoke.py``'s B2 and B7 case at recurrentgemma-9b's decode
shape (B 8, 16 query heads on one KV head, head dim 256, a 2048-slot ring,
block_s 512 or page 64; ``_hybrid_decode_case``) and prints, per pool, the
graph ms, the eager ms, the device µs of each CUDA kernel of one call
(torch.profiler), SDPA's graph ms, the bound and the kernel's readings
against its plain version under every exp backend. With ``--phi3`` the
cases are phi3-medium-14b's instead (``PHI3_DECODE_SHAPE``: B 8, 40 query
heads on 10 KV heads of 128, a 2,048-token cache): B2 in both layouts and
B7 through a page-64 table, as ``phase_phi3_kernels`` runs them. With
``--dbrx`` they are dbrx-132b's (``DBRX_DECODE_SHAPE``: B 8, 48 query
heads on 8 KV heads of 128, G 6, a 2,048-token cache, page 64): B2
"bshd" and B7, as ``phase_dbrx_kernels`` runs them.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/decode_split_stages.py [--parent DIR] [--dense]
        [--phi3] [--dbrx]

With ``--dense`` each turn also runs ``chip_smoke.py``'s gpt2-small
decode phases (B2 and B7 at head dim 64, their own JSON lines), whose
code the head-dim-256 path must leave as it was. With ``--parent``, DIR
is another checkout (say, the parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists): its kernels are
built from its own sources and the two trees run in turns, parent, this
tree, this tree, parent, each turn in a process of its own. One JSON
line per (turn, pool).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def d128_cases(chip_smoke, da, policy_cls, dbrx):
    """(pool, fields) of B2 bshd, B2 bhsd and B7 at phi3-medium's shape,
    from ``phase_phi3_kernels``' seeds, or with ``dbrx`` of B2 bshd and
    B7 at dbrx-132b's, from ``phase_dbrx_kernels``'."""
    if dbrx:
        shape = chip_smoke.DBRX_DECODE_SHAPE
        pools = (("bshd", False, "bshd", 32), ("paged", True, "bshd", 34))
    else:
        shape = chip_smoke.PHI3_DECODE_SHAPE
        pools = (("bshd", False, "bshd", 22), ("bhsd", False, "bhsd", 23),
                 ("paged", True, "bshd", 24))
    for pool, paged, layout, seed in pools:
        res, _ = chip_smoke._decode_case(
            da, policy_cls, paged,
            chip_smoke.decode_inputs(da, paged, seed=seed, layout=layout,
                                     **shape),
            shape["page"], f"d128 {pool}", layout=layout)
        yield pool, res


def worker(tree: Path, label: str, dense: bool, phi3: bool, dbrx: bool):
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch
    import chip_smoke
    from repro_torch.kernels import build, decode_attention as da
    from repro_torch.runtime import ExecPolicy
    if not torch.cuda.is_available():
        sys.exit("[decode_split_stages] no CUDA device")
    if Path(da.__file__).resolve().parents[3] != tree.resolve():
        sys.exit(f"[decode_split_stages] imported {da.__file__}, "
                 f"not {tree}")
    build.build_all(["decode_attention.cu", "decode_attention_paged.cu"])
    if phi3 or dbrx:
        for pool, res in d128_cases(chip_smoke, da, ExecPolicy, dbrx):
            print(json.dumps({"tree": label, "pool": pool, **res}),
                  flush=True)
        return
    for paged in (False, True):
        res, _ = chip_smoke._hybrid_decode_case(da, ExecPolicy, paged)
        print(json.dumps({"tree": label, "paged": paged, **res}),
              flush=True)
    if dense:
        print(json.dumps({"tree": label, "dense": True}), flush=True)
        chip_smoke.phase_decode(ExecPolicy)
        chip_smoke.phase_paged_decode(ExecPolicy)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None)
    ap.add_argument("--label", default="this")
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--phi3", action="store_true")
    ap.add_argument("--dbrx", action="store_true")
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.label, args.dense, args.phi3, args.dbrx)
        return
    turns = ([("parent", args.parent), ("this", ROOT), ("this", ROOT),
              ("parent", args.parent)] if args.parent else [("this", ROOT)])
    for label, tree in turns:
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", str(tree), "--label",
             label] + (["--dense"] if args.dense else [])
            + (["--phi3"] if args.phi3 else [])
            + (["--dbrx"] if args.dbrx else []), cwd=ROOT)
        if proc.returncode != 0:
            sys.exit(f"[decode_split_stages] the {label} turn failed "
                     f"({proc.returncode})")


if __name__ == "__main__":
    main()
