"""Contracts of the port that no numerical test shows.

* Importing every ``repro_torch`` module (``distributed/`` included) and
  ``chip_smoke.py`` pulls in neither JAX nor anything of the reference
  package ``repro``.
* With no CUDA device, the entry points (``Server``, ``api.*``, the CLI)
  raise unless the caller asks for the CPU; they never carry on there
  quietly. The card's absence is simulated, so this holds on any host.
* The kernels build for sm_90a without fast math, and nothing builds at
  import.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_jax_and_no_reference_package_imported():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {os.path.join(ROOT, "src")!r})
        sys.path.insert(0, {ROOT!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print(len(names), bad)
        assert not bad, bad
        assert len(names) >= 22, names
        assert "repro_torch.distributed.sharding" in names, names
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_cuda):
    cfg = get_config("gpt2-small").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(cfg)
    params = api.init_params(cfg, device="cpu")
    batch = {"tokens": np.zeros((1, 4), np.int32)}
    for call in (lambda: api.prefill(params, cfg, batch),
                 lambda: api.forward(params, cfg, batch),
                 lambda: api.init_cache(cfg, 1, 8),
                 lambda: api.decode_step(params, cfg, np.zeros((1, 1)), None,
                                         0),
                 lambda: serve.Server(cfg, params),
                 lambda: serve.main(["--reduced", "--requests", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_params_must_live_on_the_requested_device():
    cfg = get_config("gpt2-small").reduced()
    params = api.init_params(cfg, device="cpu")
    with pytest.raises(ValueError):
        serve.Server(cfg, params, device="meta")


def test_cli_serves_on_cpu_when_asked(capsys):
    serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                "--mixed-lengths", "--max-new", "3",
                "--policy-groups", "eval=exact,bulk=vexp_hw"])
    out = capsys.readouterr().out
    assert "served 3 requests on cpu, 9 tokens" in out


def test_build_flags_and_lazy_build(tmp_path, monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f
                   for f in build.NVCC_FLAGS)
    lib = build.KernelLib("vexp.cu")
    assert lib._lib is None and lib.launches == 0     # nothing built yet
    # a library path is keyed on the sources: editing one moves it
    monkeypatch.setattr(build, "CSRC", tmp_path)
    for name in ("vexp.cu", "vexp.cuh"):
        (tmp_path / name).write_text("// a")
    before = build.lib_path("vexp.cu")
    (tmp_path / "vexp.cuh").write_text("// b")
    assert build.lib_path("vexp.cu") != before
