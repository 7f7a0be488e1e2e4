"""The vexp kernel's design choices, timed against each other on the card.

Builds copies of ``src/repro_torch/csrc/vexp.cu`` with one choice changed
and times every copy at ``chip_smoke.py``'s vexp shape (49152 x 512,
f32 and bf16, randn x 4) as a CUDA graph of back-to-back calls, in turns
(each copy once forward, once in reverse order), beside ``torch.exp``:

- ``shipped``: the source as it is;
- ``computed_vexp_hw``: vexp_hw computed per element (``vexp_hw_bits``
  in the streaming kernel) in place of the shared-memory table, and
  ``computed_vexp_hw_f32_unroll_4`` with four f32 vectors a thread;
- ``persistent``: both forms on a persistent grid of SMs x resident CTAs
  (each an equal contiguous share) in place of one CTA per step of work;
  ``persistent_grid_stride``: the computed form's persistent CTAs stride
  over the array by the grid's width;
- ``f32_unroll_2`` / ``_4``, ``bf16_unroll_1`` / ``_2``: 16-byte vectors
  a thread of the computed form loads before its first exp (shipped: 1
  for f32, 4 for bf16), and with them the step per CTA;
- ``threads_256``: threads per CTA of the computed form (shipped: 128);
- ``table_unroll_2`` / ``_8``: vectors a thread of the table form loads
  per step (shipped: 4);
- ``table_steps_2`` / ``table_steps_4``: steps per CTA of the table form
  (fewer CTAs, so fewer table fills);
- ``plain_ld_st``: loads and stores without the streaming cache hints;
- ``no_exp``: exact and vexp with the exp cut out (their outputs are the
  inputs, so only their times count): the streaming loop alone.

``torch.exp`` and ``Tensor.copy_`` of the same tensors take their turns
beside them.

Each copy but ``no_exp`` is held bitwise (NaN-aware) to the plain version
before it is timed (exact: within 2 ulp), and its SASS instructions per
element are counted as ``chip_smoke.py`` counts them.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/vexp_forms.py

It prints one JSON line per copy (and per library call) and exits
non-zero if a change no longer matches the source or a copy disagrees
with the plain version.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, vexp as kv  # noqa: E402

F32_UNROLL = "static constexpr int kLanes = 4;\n  static constexpr int kUnroll = 1;"
BF16_UNROLL = "static constexpr int kLanes = 8;\n  static constexpr int kUnroll = 4;"
TABLE_UNROLL = "constexpr int kTableUnroll = 4;"
THREADS = "constexpr int kThreads = 128;"
TABLE_GRID = "grid_for(n, Vec<T>::kLanes, kTableThreads, kTableUnroll);"
# a persistent grid: SMs x resident CTAs (the occupancy query per launch)
PERSISTENT = [
    ("""  const long long blocks =
      grid_for(n, Vec<T>::kLanes, kThreads, Vec<T>::kUnroll);""",
     """  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, vexp_stream_kernel<T, BACKEND>, kThreads, 0);
  const long long need =
      grid_for(n, Vec<T>::kLanes, kThreads, Vec<T>::kUnroll);
  const long long blocks = need < (long long)sms * per_sm
                               ? need : (long long)sms * per_sm;"""),
    ("  const long long blocks =\n      " + TABLE_GRID,
     """  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = """ + TABLE_GRID + """
  const long long blocks = need < sms ? need : sms;""")]
# the persistent computed form striding by the grid's width
GRID_STRIDE = ("""  long long lo, hi;
  cta_share(nvec, &lo, &hi);
#pragma unroll 1
  for (long long base = lo + threadIdx.x; base < hi;
       base += kThreads * kUnroll) {""", """  const long long hi = nvec;
#pragma unroll 1
  for (long long base = (long long)blockIdx.x * kThreads * kUnroll +
                        threadIdx.x;
       base < hi; base += (long long)gridDim.x * kThreads * kUnroll) {""")
PLAIN_LD_ST = [("__ldcs(xv + i)", "xv[i]"),
               ("__stcs(yv + i, exp_vec<BACKEND>(v[u]))",
                "yv[i] = exp_vec<BACKEND>(v[u])"),
               ("__stcs(yv + i, lookup_vec(lut, v[u]))",
                "yv[i] = lookup_vec(lut, v[u])")]
HW_F32 = ("launch_table<float>(x, y, n, table, s)",
          "launch_stream<float, vexp::kVexpHw>(x, y, n, s)")
HW_BF16 = ("launch_table<__nv_bfloat16>(x, y, n, table, s)",
           "launch_stream<__nv_bfloat16, vexp::kVexpHw>(x, y, n, s)")
# copy -> text replacements in the source
CHANGES = {
    "shipped": [],
    "computed_vexp_hw": [HW_F32, HW_BF16],
    "computed_vexp_hw_f32_unroll_4": [HW_F32, HW_BF16,
                                      (F32_UNROLL, F32_UNROLL[:-2] + "4;")],
    "persistent": PERSISTENT,
    "persistent_grid_stride": PERSISTENT + [GRID_STRIDE],
    "f32_unroll_2": [(F32_UNROLL, F32_UNROLL[:-2] + "2;")],
    "f32_unroll_4": [(F32_UNROLL, F32_UNROLL[:-2] + "4;")],
    "bf16_unroll_1": [(BF16_UNROLL, BF16_UNROLL[:-2] + "1;")],
    "bf16_unroll_2": [(BF16_UNROLL, BF16_UNROLL[:-2] + "2;")],
    "threads_256": [(THREADS, "constexpr int kThreads = 256;")],
    "table_unroll_2": [(TABLE_UNROLL, "constexpr int kTableUnroll = 2;")],
    "table_unroll_8": [(TABLE_UNROLL, "constexpr int kTableUnroll = 8;")],
    "table_steps_2": [(TABLE_GRID, f"({TABLE_GRID[:-1]} + 1) / 2;")],
    "table_steps_4": [(TABLE_GRID, f"({TABLE_GRID[:-1]} + 3) / 4;")],
    "plain_ld_st": PLAIN_LD_ST,
    "no_exp": [("return vexp::apply_exp(BACKEND, v);", "return v;")],
}
BACKENDS = ("exact", "vexp", "vexp_hw")


def build_copies(out_dir: Path) -> dict:
    src = (build.CSRC / "vexp.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, changes in CHANGES.items():
        text = src
        for old, new in changes:
            if old not in text:
                sys.exit(f"[vexp_forms] {name}: {old!r} not in the source")
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
            sys.exit(f"[vexp_forms] nvcc failed on {name}:\n{out}")
    return {name: out_dir / f"{name}.so" for name in CHANGES}


def launcher(so: Path, table: torch.Tensor):
    fn = ctypes.CDLL(str(so)).vexp_launch
    fn.argtypes = [build.P, build.P, build.LL, build.I, build.I, build.P,
                   build.P]
    fn.restype = ctypes.c_int

    def run(x, y, exp):
        code = fn(x.data_ptr(), y.data_ptr(), x.numel(),
                  0 if x.dtype == torch.float32 else 1,
                  build.BACKEND_CODE[exp], table.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"vexp_launch of {so.name}: CUDA error {code}")
    return run


def check(run, x, exp, name):
    y = torch.empty_like(x)
    run(x, y, exp)
    ref = kv.vexp_plain(x, exp)
    if exp == "exact":
        bad = int((cs.f32_ulp_distance(y.float(), ref.float()) > 2 * (
            1 << 16 if x.dtype == torch.bfloat16 else 1)).sum())
    else:
        bad = int((~cs.nan_aware_equal(y, ref)).sum())
    if bad:
        sys.exit(f"[vexp_forms] {name} {exp} {x.dtype}: {bad} outputs "
                 f"off the plain version")


def main():
    if not torch.cuda.is_available():
        sys.exit("[vexp_forms] no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_copies(build.BUILD_ROOT / "vexp_forms")
    table = kv.vexp_hw_table(torch.device("cuda"))
    runs = {name: launcher(so, table) for name, so in libs.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    x32 = torch.randn(cs.VEXP_SHAPE, generator=g, device="cuda") * 4.0
    xs = {"f32": x32, "bf16": x32.to(torch.bfloat16)}
    for name, run in runs.items():
        for x in xs.values():
            for exp in BACKENDS:
                if name != "no_exp" or exp == "vexp_hw":
                    check(run, x, exp, name)
    ys = {d: torch.empty_like(x) for d, x in xs.items()}
    timed = dict(runs)
    timed["torch.exp"] = lambda x, y, exp: torch.exp(x, out=y)
    timed["torch.copy_"] = lambda x, y, exp: y.copy_(x)
    graph = {name: {} for name in timed}
    for name in list(timed) + list(timed)[::-1]:
        for d, x in xs.items():
            for exp in BACKENDS if name in runs else ("exact",):
                ms = cs.cuda_graph_time_ms(
                    lambda: timed[name](x, ys[d], exp), iters=10)
                key = f"{exp}_{d}" if name in runs else d
                graph[name].setdefault(key, []).append(ms)
    for name in timed:
        line = {"variant": name, "graph_ms": graph[name], "nvidia_smi": smi}
        if name in libs:
            line["sass_per_elem"] = {
                k: {f: round(v, 3) for f, v in per.items()}
                for k, per in cs.vexp_sass_counts(libs[name]).items()}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
