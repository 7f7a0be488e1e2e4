"""Where the head-dim-256 flash-decode sweep's time goes, on the card.

Runs ``chip_smoke.py``'s B2 and B7 case at recurrentgemma-9b's decode
shape (B 8, 16 query heads on one KV head, head dim 256, a 2048-slot ring,
block_s 512 or page 64; ``_hybrid_decode_case``) and prints, per pool, the
graph ms, the eager ms, the device µs of each CUDA kernel of one call
(torch.profiler), SDPA's graph ms, the bound and the kernel's readings
against its plain version under every exp backend.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/decode_split_stages.py [--parent DIR] [--dense]

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


def worker(tree: Path, label: str, dense: bool):
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
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.label, args.dense)
        return
    turns = ([("parent", args.parent), ("this", ROOT), ("this", ROOT),
              ("parent", args.parent)] if args.parent else [("this", ROOT)])
    for label, tree in turns:
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", str(tree), "--label",
             label] + (["--dense"] if args.dense else []), cwd=ROOT)
        if proc.returncode != 0:
            sys.exit(f"[decode_split_stages] the {label} turn failed "
                     f"({proc.returncode})")


if __name__ == "__main__":
    main()
