"""Build and load the hand-written Hopper kernels (nvcc + ctypes).

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` into a shared
library with a plain C interface, for ``sm_90a``, and loaded with
``ctypes``. Libraries go to ``build/repro_torch/<hash>/`` at the root of
the checkout (listed in ``.gitignore``), keyed on a hash of every source
they include, so a source edit rebuilds and an unchanged tree loads what
is there. Nothing builds at import: the first launch builds its library,
and ``build_all`` builds every library at once, one ``nvcc`` per source,
all started together.

Not compiled with ``--use_fast_math``: it would turn ``expf`` into
``__expf`` and flush subnormals, and the exp helpers must match their
plain versions bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v"]
HEADERS = ("vexp.cuh",)                 # included by every source
SOURCE_HEADERS = {"decode_attention.cu": ("decode_split.cuh",),
                  "decode_attention_paged.cu": ("decode_split.cuh",)}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS + SOURCE_HEADERS.get(source, ()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def lib_path(source: str) -> Path:
    return BUILD_ROOT / _digest(source) / (Path(source).stem + ".so")


def _nvcc_cmd(source: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / source)]


def build_all(sources) -> dict:
    """Compile every library that is not built yet, one ``nvcc`` process
    per source, all running at once. Returns {source: path}. Raises with
    the compiler's output if any build fails."""
    todo, procs, paths = [], [], {}
    for src in sources:
        path = lib_path(src)
        paths[src] = path
        if not path.exists():
            todo.append((src, path))
    for src, path in todo:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkstemp(suffix=".so", dir=path.parent)[1])
        proc = subprocess.Popen(_nvcc_cmd(src, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((src, path, tmp, proc))
    errors = []
    for src, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {src}:\n{out}")
        else:
            # ptxas register / shared-memory / spill report per kernel
            path.with_suffix(".log").write_text(out)
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


class KernelLib:
    """A compiled source's ctypes handle and one launch counter.

    ``fn(name)`` returns the C entry with its argument types set, looked
    up once per name; each C entry returns ``cudaGetLastError()`` and
    ``check`` raises on a non-zero code. ``launches`` counts the kernel
    launches made through the wrappers that check against this object
    and nothing else; a source with several kernels has one object per
    kernel, sharing the loaded library."""

    def __init__(self, source: str):
        self.source = source
        self.launches = 0
        self._lib = None
        self._fns = {}

    def load(self):
        if self._lib is None:
            path = build_all([self.source])[self.source]
            self._lib = ctypes.CDLL(str(path))
        return self._lib

    def fn(self, name: str, argtypes, restype=ctypes.c_int):
        f = self._fns.get(name)
        if f is None:
            f = getattr(self.load(), name)
            f.argtypes = argtypes
            f.restype = restype
            self._fns[name] = f
        return f

    def check(self, code: int, what: str):
        if code != 0:
            raise RuntimeError(f"{what}: CUDA error {code} "
                               f"(cudaGetLastError after launch)")
        self.launches += 1


# exp backend codes of csrc/vexp.cuh (enum Backend)
BACKEND_CODE = {"exact": 0, "vexp": 1, "vexp_hw": 2}

P = ctypes.c_void_p     # device pointer or stream handle
I = ctypes.c_int
F = ctypes.c_float
LL = ctypes.c_longlong
