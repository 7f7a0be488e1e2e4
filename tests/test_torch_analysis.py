"""``repro_torch.analysis``, the AST lint of the port: every rule catches
its planted violation (sources written into ``tmp_path``), a clean
source stays quiet, the gate passes on ``src/repro_torch``, and the
baseline machinery (reasons, step-strict rejection, stale entries, exit
codes 0 / 1 / 2) behaves as the reference's (``tests/test_analysis.py``).
"""

import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import Severity, run_rules
from repro_torch.analysis.baseline import BaselineError, load_baseline
from repro_torch.analysis.cli import main, run_analysis
from repro_torch.analysis.registry import STEP_STRICT, hot_path, is_hot_path
from repro_torch.analysis.rules import (CaptureHazardRule, EngineContractRule,
                                        FallbackContractRule, HostSyncRule,
                                        RefcountRule, canon_path)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _plant(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(textwrap.dedent(text))
    return str(path)


def _details(findings, rule):
    return sorted(f.detail for f in findings if f.rule == rule)


HOST_SYNC = """
    import numpy as np
    import torch
    from repro_torch.analysis.registry import hot_path


    @hot_path
    def step(x, out):
        a = x.item()
        b = x.tolist()
        c = x.cpu()
        d = x.cpu().numpy()
        e = out.numpy()
        torch.cuda.synchronize()
        torch.cuda.current_stream().synchronize()
        f = x.to("cpu")
        g = x.to(device=torch.device("cpu"))
        h = np.asarray(x)
        n = int(x)
        ok = np.asarray([1, 2]) + int(3)
        return a, b, c, d, e, f, g, h, n, ok


    @hot_path
    def outer(x):
        def inner(y):
            return y.tolist()
        return inner(x)


    def cold_path(x):
        return x.item(), x.cpu().numpy(), int(x)
"""


def test_host_sync_catches_each_planted_sync(tmp_path):
    fs, n = run_rules([_plant(tmp_path, "sync.py", HOST_SYNC)],
                      rules=[HostSyncRule()])
    assert n == 1
    assert _details(fs, "host-sync-in-hot-path") == sorted([
        ".item()", ".tolist()", ".cpu()", ".cpu().numpy()", ".numpy()",
        "torch.cuda.synchronize", ".synchronize()", '.to("cpu")',
        '.to("cpu")', "np.asarray", "int()", ".tolist()"])
    by = {(f.symbol, f.detail): f for f in fs}
    # nested defs inherit hotness, under their own qualname
    assert ("outer.inner", ".tolist()") in by
    assert by["step", "int()"].severity is Severity.WARN
    assert by["step", ".item()"].severity is Severity.ERROR
    # unmarked code and literals are not findings
    assert not [f for f in fs if f.symbol == "cold_path"]


def test_host_sync_sees_registered_globs(tmp_path):
    path = _plant(tmp_path, "wrappers.py", """
        def _launch_contig(x):
            return int(x)
        def other(x):
            return int(x)
    """)
    fs, _ = run_rules([path], rules=[HostSyncRule(
        extra_functions={"wrappers.py": ("_launch_*",)})])
    assert [(f.symbol, f.detail) for f in fs] == [("_launch_contig",
                                                   "int()")]


def test_refcount_pairing(tmp_path):
    path = _plant(tmp_path, "pool.py", """
        class Pool:
            def incref(self, gid):
                self.refs[gid] += 1
            def cow(self, gid):
                self.refs[gid] -= 1
            def grab(self, cols):
                got = []
                for c in cols:
                    got.append(self.alloc_cols([c]))
                return got
            def grab_guarded(self, cols):
                got = []
                try:
                    for c in cols:
                        got.extend(self.alloc_cols([c]))
                except Exception:
                    for gid in got:
                        self.decref(gid)
                    raise
                return got
    """)
    fs, _ = run_rules([path], rules=[RefcountRule(targets=("pool.py",))])
    assert sorted((f.symbol, f.detail) for f in fs) == [
        ("Pool.cow", "refs[...]-mutation"),
        ("Pool.grab", "unguarded-alloc_cols-loop")]
    # outside the registered modules the rule stays quiet
    assert not run_rules([path], rules=[RefcountRule()])[0]


def test_refcount_pairing_unguarded_slot_reserve(tmp_path):
    """A ``begin_chunk`` in an admission loop needs a slot release on its
    raise path; a guarded loop, a reserve outside any loop, and the
    engine's own chunk admission pass."""
    path = _plant(tmp_path, "engine.py", """
        class Group:
            def admit_bad(self):
                while self.queue:
                    cur = self.state.begin_chunk(0, self.queue[0], 4)
                    self.prefilling[0] = (self.queue.popleft(), cur)
            def admit_guarded(self):
                for j in self.free:
                    try:
                        cur = self.state.begin_chunk(j, self.queue[0], 4)
                        self.prefilling[j] = (self.queue.popleft(), cur)
                    except BaseException:
                        self.state.abort_chunk(j)
                        raise
            def admit_once(self):
                return self.state.begin_chunk(0, self.queue[0], 4)
    """)
    rule = RefcountRule(targets=("none.py",), slot_targets=("engine.py",))
    fs, _ = run_rules([path], rules=[rule])
    assert [(f.symbol, f.detail, f.severity) for f in fs] == [
        ("Group.admit_bad", "unguarded-slot-reserve", Severity.ERROR)]
    engine = os.path.join(SRC, "repro_torch", "launch", "serve.py")
    assert "begin_chunk" in open(engine).read()
    assert not run_rules([engine], rules=[RefcountRule()])[0]


def test_refcount_pairing_unguarded_spec_snapshot(tmp_path):
    """A ``spec_snapshot`` needs a rollback or recovery on its raise path,
    in a loop or not (the reference's check): an unguarded burst and one
    whose handler reaches no rollback are caught; a burst guarded by a
    recovery, or by a finally that verifies, passes, and so does the
    engine's own burst."""
    path = _plant(tmp_path, "engine.py", """
        class Group:
            def burst_bad(self):
                snap = self.state.spec_snapshot(self.last)
                self.state.draft_step(self.last, self.live)
                return self.state.verify_step(snap, self.live)
            def burst_wrong_handler(self):
                try:
                    snap = self.state.spec_snapshot(self.last)
                    return self.state.verify_step(snap, self.live)
                except RuntimeError:
                    self.log("failed")
                    raise
            def burst_recovered(self):
                try:
                    snap = self.state.spec_snapshot(self.last)
                    return self.state.verify_step(snap, self.live)
                except RuntimeError:
                    self._recover_step_fault()
            def burst_settled(self):
                try:
                    snap = self.state.spec_snapshot(self.last)
                    self.state.draft_step(self.last, self.live)
                finally:
                    self.state.verify_step(snap, self.live)
    """)
    rule = RefcountRule(targets=("none.py",), slot_targets=("engine.py",))
    fs, _ = run_rules([path], rules=[rule])
    assert sorted((f.symbol, f.detail, f.severity) for f in fs) == [
        ("Group.burst_bad", "unguarded-spec-snapshot", Severity.ERROR),
        ("Group.burst_wrong_handler", "unguarded-spec-snapshot",
         Severity.ERROR)]
    engine = os.path.join(SRC, "repro_torch", "launch", "serve.py")
    assert "spec_snapshot" in open(engine).read()
    assert not run_rules([engine], rules=[RefcountRule()])[0]


def test_capture_hazard(tmp_path):
    path = _plant(tmp_path, "hazard.py", """
        import functools
        import torch
        from repro_torch.analysis.registry import hot_path

        @hot_path
        def step(x, seen=[]):
            seen.append(x)
            return x

        def cold(x, seen=[]):
            return x

        @functools.lru_cache(maxsize=None)
        def table(t):
            return torch.exp(t)

        @functools.lru_cache(maxsize=None)
        def shape_only(n):
            return torch.zeros((n,))
    """)
    fs, _ = run_rules([path], rules=[CaptureHazardRule()])
    assert sorted((f.symbol, f.detail, f.severity) for f in fs) == [
        ("step", "mutable-default", Severity.ERROR),
        ("table", "lru_cache-tensor-arg", Severity.WARN)]


def test_engine_family_branch(tmp_path):
    path = _plant(tmp_path, "engine.py", """
        def admit(self, cfg):
            if cfg.family == "ssm":
                raise NotImplementedError("ssm")
    """)
    fs, _ = run_rules([path], rules=[EngineContractRule(
        targets=("engine.py",))])
    assert _details(fs, "engine-family-branch") == [".family",
                                                    "NotImplementedError"]


FALLBACK = """
    def decode_attention(q, k, v, cache_len, *, window=None,
                         layout="bshd", policy):
        if q.device.type == "cpu":
            return decode_attention_plain(q, k, v, cache_len)
        if layout == "bhsd" or window is not None:
            return decode_attention_reference(q, k, v, cache_len)
        return _launch_contig(q, k, v, cache_len)


    def clean(q, k, v, cache_len, *, layout="bshd", policy):
        if q.device.type == "cpu":
            return decode_attention_plain(q, k, v, cache_len)
        return _launch_contig(q, k, v, cache_len)


    def lost(q, k, v, cache_len, *, policy):
        return decode_attention_plain(q, k, v, cache_len)
"""


def test_silent_fallback(tmp_path):
    path = _plant(tmp_path, "route.py", FALLBACK)

    def contract(fn):
        return {"path": "route.py", "function": fn,
                "forbid_if_names": ("layout", "window", "cache_len"),
                "forbid_call_substrings": ("_plain", "_reference"),
                "host_gate": True, "require_call": "_launch_contig"}

    fs, _ = run_rules([path], rules=[FallbackContractRule(
        contracts=[contract(f) for f in ("decode_attention", "clean",
                                         "lost")])])
    got = sorted((f.symbol, f.detail) for f in fs)
    assert got == [("decode_attention", "call-_reference"),
                   ("decode_attention", "if-layout"),
                   ("decode_attention", "if-window"),
                   ("lost", "call-_plain"),
                   ("lost", "missing-_launch_contig")]


def test_clean_source_is_clean(tmp_path):
    path = _plant(tmp_path, "clean.py", """
        import torch
        from repro_torch.analysis.registry import hot_path

        @hot_path
        def step(c, out):
            out.copy_(c["last"])
            c["pos"].add_(c["live"])
            return out
    """)
    fs, n = run_rules([path])
    assert n == 1 and fs == []


# ------------------------------------------------------------ the gate

def test_gate_passes_on_the_port():
    """``python -m repro_torch.analysis src/repro_torch`` exits 0, with
    torch never imported by the lint."""
    code = ("import runpy, sys; sys.argv = ['x', 'src/repro_torch']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert 'torch' not in sys.modules, 'lint imported torch'\n"
            "    raise\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "repro_torch.analysis: ok" in out.stdout


def test_shipped_baseline_is_valid_and_scheduling_only():
    base = load_baseline()
    assert {e["symbol"] for e in base.entries} == {"_Group.admit",
                                                   "_Group._finish"}
    res = run_analysis([os.path.join(SRC, "repro_torch")])
    assert not res.new and not res.stale
    assert len(res.suppressed) == len(base.entries)


def _baseline(tmp_path, where, symbol, reason):
    path = tmp_path / "baseline.toml"
    path.write_text(textwrap.dedent(f"""\
        version = 1

        [[suppress]]
        rule = "host-sync-in-hot-path"
        path = "repro_torch/{where}"
        symbol = "{symbol}"
        detail = ".item()"
        reason = "{reason}"
    """))
    return str(path)


@pytest.mark.parametrize("where,symbol,reason", [
    ("launch/serve.py", "_Group.admit", "TODO: justify this suppression"),
    ("launch/serve.py", "_Group.decode_once",
     "the step reads one scalar per token"),
    ("models/decode_state.py", "KVDecodeState.step",
     "one sync is cheap enough"),
    ("kernels/decode_attention.py", "_launch_paged",
     "the offset is a host int"),
], ids=["placeholder", "decode_once", "state-step", "launch-wrapper"])
def test_bad_baseline_exits_2(tmp_path, capsys, where, symbol, reason):
    path = _baseline(tmp_path, where, symbol, reason)
    with pytest.raises(BaselineError):
        load_baseline(path)
    assert main([os.path.join(SRC, "repro_torch"), "--baseline",
                 path]) == 2


def test_planted_item_in_a_hot_step_exits_1(tmp_path, capsys):
    path = _plant(tmp_path, "serve.py", """
        from repro_torch.analysis.registry import hot_path

        @hot_path
        def decode_once(self):
            out = self.state.step(self.last, self.live_dev)
            return out.item()
    """)
    assert main([path]) == 1
    assert ".item()" in capsys.readouterr().out
    assert main([path, "--no-baseline", "--json"]) == 1


def test_written_baseline_fails_until_justified(tmp_path, capsys):
    path = _plant(tmp_path, "admit.py", """
        from repro_torch.analysis.registry import hot_path

        @hot_path
        def admit(x):
            return x.item()
    """)
    base = str(tmp_path / "written.toml")
    assert main([path, "--baseline", base, "--write-baseline"]) == 0
    assert main([path, "--baseline", base]) == 2
    text = open(base).read().replace("TODO: justify this suppression",
                                     "one sync per admission wave")
    open(base, "w").write(text)
    assert main([path, "--baseline", base]) == 0
    # a stale entry is reported, not failed
    assert main([_plant(tmp_path, "quiet.py", "x = 1\n"), "--baseline",
                 base]) == 0
    assert "stale baseline entry" in capsys.readouterr().out


def test_registry_and_paths():
    def f():
        return 1
    assert hot_path(f) is f and is_hot_path(f) and f() == 1
    assert canon_path("/a/b/src/repro_torch/launch/serve.py") == \
        "repro_torch/launch/serve.py"
    assert canon_path("./x/y.py") == "x/y.py"
    assert all(p.startswith("repro_torch/") for p, _ in STEP_STRICT)
