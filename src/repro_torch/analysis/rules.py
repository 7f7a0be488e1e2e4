"""AST lint rules over ``src/repro_torch/**`` (port of
``repro/analysis/rules.py``; the catalog of its ``:1-45``, with the torch
counterparts of the JAX constructs).

Pure stdlib: the analyzed modules are never imported, so the rules run
anywhere, on planted sources that would not even import. Each rule is a
class with a stable kebab-case ``name`` and ``check(SourceModule) ->
[Finding]``; where it applies is decided by path suffix, with
constructor overrides so the tests can aim a rule at planted files.

The catalog (severities in parentheses):

``host-sync-in-hot-path``
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` (a
    ``.cpu().numpy()`` chain is one finding), ``.synchronize()``,
    ``torch.cuda.synchronize``, ``Tensor.to("cpu")`` and
    ``np.asarray`` / ``np.array`` on a non-literal (error); bare
    ``int()`` / ``float()`` / ``bool()`` on a non-constant (warn: the
    argument may be a host scalar), inside functions marked
    ``@hot_path`` or registered in ``registry.HOT_PATH_FUNCTIONS``, and
    their nested functions. In the decode step each one is a sync per
    token, and a sync inside CUDA-graph capture breaks the capture.

``refcount-pairing``
    Raw mutation of ``.refs`` outside the refcount primitives (error: a
    raw decrement skips the free-list return), allocation or incref
    loops with no release-on-exception guard (error: a raise mid-loop
    strands every reference already taken), and in the engine a
    ``begin_chunk`` inside an admission loop with no try in that loop
    whose handlers reach a slot release (``abort_chunk`` /
    ``reset_slots``; error ``unguarded-slot-reserve``: a raise between
    reserve and publish strands the slot's pages), and a
    ``spec_snapshot`` outside any try whose handlers reach a rollback or
    recovery (``spec_restore`` / ``verify_step`` / ``reset_slots`` /
    ``_recover_step_fault``; error ``unguarded-spec-snapshot``: a raise
    mid-burst leaves the positions advanced by the drafts with no way
    back).

``capture-hazard`` (the counterpart of ``jit-retrace-hazard``)
    A mutable default argument on a ``@hot_path`` function (error: state
    shared across calls, and a graph records whatever the first call
    saw), and ``functools.lru_cache`` over a function whose parameters
    flow into tensor ops (warn: tensor-keyed memoization pins device
    buffers alive, or hands a captured buffer to a later caller).

``engine-family-branch``
    ``launch/serve.py`` stays family-agnostic: any ``*.family`` access
    or ``NotImplemented`` / ``NotImplementedError`` in the engine is an
    error.

``silent-fallback``
    The decode launch wrappers route every configuration to their kernel:
    no If on layout / window / cache_len, no call of a ``*_plain`` or
    ``_*_reference`` function except under the one device gate
    (``if <tensor>.device.type == "cpu":``); core ``decode_attention``
    routes through ``dispatch`` only.
"""

from __future__ import annotations

import ast
import fnmatch
import os
from dataclasses import dataclass, field

from . import registry
from .findings import Finding, Severity


def canon_path(path: str) -> str:
    """Stable path identity for baselines: posix separators, cut to the
    ``repro_torch/``-rooted suffix where there is one."""
    p = path.replace(os.sep, "/")
    marker = "/repro_torch/"
    i = p.find(marker)
    if i >= 0:
        return p[i + 1:]
    if p.startswith("repro_torch/"):
        return p
    return p.lstrip("./")


def _dotted(node) -> str | None:
    """'torch.cuda.synchronize' for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_name(call) -> str | None:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


_LITERALS = (ast.List, ast.Tuple, ast.Dict, ast.Set, ast.ListComp,
             ast.DictComp, ast.SetComp, ast.GeneratorExp, ast.Constant)


@dataclass
class SourceModule:
    """One parsed file and the maps every rule needs."""

    path: str
    text: str
    tree: ast.AST
    parents: dict = field(default_factory=dict)
    # function node -> dotted qualname ("Class.method", "outer.inner")
    qualnames: dict = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str) -> "SourceModule":
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        tree = ast.parse(text, filename=path)
        mod = cls(path=path, text=text, tree=tree)
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                mod.parents[child] = parent

        def visit(node, stack):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = stack + [child.name]
                    mod.qualnames[child] = ".".join(q)
                    visit(child, q)
                elif isinstance(child, ast.ClassDef):
                    visit(child, stack + [child.name])
                else:
                    visit(child, stack)
        visit(tree, [])
        return mod

    def functions(self):
        """(node, qualname) of every (async) function def."""
        return self.qualnames.items()

    def enclosing_function(self, node) -> str:
        """Qualname of the innermost function holding ``node`` ('' at
        module level)."""
        cur = node
        while cur is not None:
            if cur in self.qualnames:
                return self.qualnames[cur]
            cur = self.parents.get(cur)
        return ""

    def ancestors(self, node):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)


def _walk_in_function(fn_node):
    """A function's own code: everything but nested function and class
    defs (those are checked under their own qualname)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _contains(root, node) -> bool:
    return any(n is node for n in ast.walk(root))


def _suffix_match(path: str, suffixes) -> bool:
    c = canon_path(path)
    return any(c.endswith(canon_path(s)) for s in suffixes)


def _hot_functions(mod, extra_functions=None):
    """Function nodes of ``mod`` on the hot path: marked ``@hot_path``,
    matched by a registered glob, or nested in one of those."""
    globs = []
    for table in (registry.HOT_PATH_FUNCTIONS, extra_functions or {}):
        for suffix, pats in table.items():
            if _suffix_match(mod.path, (suffix,)):
                globs.extend(pats)
    hot = set()
    for node, qual in mod.functions():
        marked = any((_dotted(d) or "").split(".")[-1] == "hot_path"
                     for d in node.decorator_list)
        if marked or any(fnmatch.fnmatch(qual, g) for g in globs):
            hot.add(node)
    for node, _ in mod.functions():
        if node not in hot and any(a in hot for a in mod.ancestors(node)):
            hot.add(node)
    return hot


class Rule:
    name = "rule"

    def check(self, mod: SourceModule):
        raise NotImplementedError


# --------------------------------------------------------------- host sync

_SYNC_METHODS = {"item": ".item()", "tolist": ".tolist()",
                 "cpu": ".cpu()", "numpy": ".numpy()",
                 "synchronize": ".synchronize()"}
_SYNC_DOTTED = {"torch.cuda.synchronize": "device sync"}
_NP_ROOTS = ("np", "numpy")
_SCALARIZERS = ("int", "float", "bool")


def _is_cpu_device(node) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call)
            and (_dotted(node.func) or "").endswith("device")
            and bool(node.args) and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


class HostSyncRule(Rule):
    """Host syncs and device->host copies inside hot-path functions."""

    name = "host-sync-in-hot-path"

    def __init__(self, extra_functions=None):
        # extra {path suffix: qualname globs} on top of the registry
        self.extra_functions = dict(extra_functions or {})

    def check(self, mod):
        out = []
        for fn in _hot_functions(mod, self.extra_functions):
            qual = mod.qualnames[fn]
            for node in _walk_in_function(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = self._classify(mod, node)
                if f is None:
                    continue
                detail, sev, msg = f
                out.append(Finding(rule=self.name, severity=sev,
                                   path=mod.path, line=node.lineno,
                                   symbol=qual, detail=detail, message=msg))
        return out

    @staticmethod
    def _classify(mod, call):
        func = call.func
        if isinstance(func, ast.Attribute):
            dotted = _dotted(func)
            if dotted in _SYNC_DOTTED:
                return (dotted, Severity.ERROR,
                        f"{dotted}(...) is a {_SYNC_DOTTED[dotted]}: the "
                        f"decode step must stay asynchronous on the device")
            root = dotted.split(".")[0] if dotted else None
            if root in _NP_ROOTS and func.attr in ("asarray", "array"):
                arg = call.args[0] if call.args else None
                if arg is not None and not isinstance(arg, _LITERALS):
                    d = f"{root}.{func.attr}"
                    return (d, Severity.ERROR,
                            f"{d}(...) on a non-literal copies a device "
                            f"value to the host (a blocking sync)")
                return None
            if func.attr == "to" and (
                    (call.args and _is_cpu_device(call.args[0]))
                    or any(k.arg == "device" and _is_cpu_device(k.value)
                           for k in call.keywords)):
                return ('.to("cpu")', Severity.ERROR,
                        '.to("cpu") copies the tensor to the host and '
                        'waits for the device')
            if func.attr in _SYNC_METHODS and not call.args:
                if func.attr == "cpu":
                    up = mod.parents.get(call)
                    if isinstance(up, ast.Attribute) and up.attr == "numpy":
                        return None        # reported as .cpu().numpy()
                d = _SYNC_METHODS[func.attr]
                if (func.attr == "numpy" and isinstance(func.value, ast.Call)
                        and isinstance(func.value.func, ast.Attribute)
                        and func.value.func.attr == "cpu"):
                    d = ".cpu().numpy()"
                return (d, Severity.ERROR,
                        f"{d} waits for the device value: one sync per "
                        f"call on the decode hot path, and none is "
                        f"allowed inside a CUDA-graph capture")
        elif isinstance(func, ast.Name) and func.id in _SCALARIZERS:
            if len(call.args) == 1 and not isinstance(call.args[0],
                                                      ast.Constant):
                return (f"{func.id}()", Severity.WARN,
                        f"{func.id}(...) scalarizes its argument: a "
                        f"blocking sync if it is a device tensor (host "
                        f"values are fine; justify in the baseline)")
        return None


# ---------------------------------------------------------------- refcount

class RefcountRule(Rule):
    """Refcount-pairing discipline in the page-pool bookkeeping."""

    name = "refcount-pairing"

    def __init__(self, targets=None, slot_targets=None):
        self.targets = tuple(targets or registry.ALLOC_MODULES)
        self.slot_targets = tuple(slot_targets or registry.SLOT_MODULES)

    def check(self, mod):
        out = []
        alloc = _suffix_match(mod.path, self.targets)
        slots = _suffix_match(mod.path, self.slot_targets)
        for node in ast.walk(mod.tree):
            if alloc:
                out.extend(self._raw_refs(mod, node))
            if isinstance(node, ast.Call):
                if alloc:
                    out.extend(self._unguarded_alloc(mod, node))
                if slots:
                    out.extend(self._unguarded_slot_reserve(mod, node))
                    out.extend(self._unguarded_spec_snapshot(mod, node))
        return out

    def _raw_refs(self, mod, node):
        if isinstance(node, ast.AugAssign):
            targets = [node.target]
        elif isinstance(node, ast.Assign):
            targets = node.targets
        else:
            return []
        hits = []
        for t in targets:
            if not (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Attribute)
                    and t.value.attr == "refs"):
                continue
            qual = mod.enclosing_function(t)
            if qual.split(".")[-1] in registry.REFS_PRIMITIVES:
                continue
            hits.append(Finding(
                rule=self.name, severity=Severity.ERROR, path=mod.path,
                line=t.lineno, symbol=qual, detail="refs[...]-mutation",
                message="raw refcount mutation outside the incref/decref "
                        "primitives: a raw decrement skips the free-list "
                        "return"))
        return hits

    def _unguarded_alloc(self, mod, call):
        name = _call_name(call)
        if name not in registry.ALLOC_CALLS:
            return []
        in_loop = guarded = False
        for anc in mod.ancestors(call):
            if isinstance(anc, (ast.For, ast.While)):
                in_loop = True
            if isinstance(anc, ast.Try):
                in_body = any(_contains(s, call) for s in anc.body)
                if in_body and self._releases(anc):
                    guarded = True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
        if not in_loop or guarded:
            return []
        return [Finding(
            rule=self.name, severity=Severity.ERROR, path=mod.path,
            line=call.lineno, symbol=mod.enclosing_function(call),
            detail=f"unguarded-{name}-loop",
            message=f"loop takes references via {name}(...) with no "
                    f"release-on-exception guard: a raise mid-loop "
                    f"strands every page already taken")]

    def _unguarded_slot_reserve(self, mod, call):
        """A slot reserve (``begin_chunk``) inside a loop needs some try
        in that loop whose handlers or finally reach a slot release (port
        of the reference's check, ``rules.py:368-410``)."""
        name = _call_name(call)
        if name not in registry.SLOT_RESERVE_CALLS:
            return []
        loop = None
        for anc in mod.ancestors(call):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            if isinstance(anc, (ast.For, ast.While)):
                loop = anc
                break
        if loop is None or any(
                isinstance(n, ast.Try) and self._releases(
                    n, registry.SLOT_RELEASE_CALLS)
                for n in ast.walk(loop)):
            return []
        return [Finding(
            rule=self.name, severity=Severity.ERROR, path=mod.path,
            line=call.lineno, symbol=mod.enclosing_function(call),
            detail="unguarded-slot-reserve",
            message=f"{name}(...) reserves a slot's pages and prefix "
                    f"references inside an admission loop with no slot "
                    f"release (abort_chunk / reset_slots) on the raise "
                    f"path: one raise between reserve and publish strands "
                    f"the reservation")]

    def _unguarded_spec_snapshot(self, mod, call):
        """A ``spec_snapshot`` must sit in the body of some try whose
        handlers or finally reach a rollback or recovery call (port of
        the reference's check, ``rules.py:412-450``). Unlike
        ``begin_chunk`` it is a straight-line reserve: it hands back the
        burst's only rollback token, then the draft steps advance the
        pool's positions in place, so every snapshot is checked, in a
        loop or not."""
        name = _call_name(call)
        if name not in registry.SPEC_SNAPSHOT_CALLS:
            return []
        for anc in mod.ancestors(call):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            if isinstance(anc, ast.Try) and \
                    any(_contains(s, call) for s in anc.body) and \
                    self._releases(anc, registry.SPEC_SNAPSHOT_RELEASES):
                return []
        return [Finding(
            rule=self.name, severity=Severity.ERROR, path=mod.path,
            line=call.lineno, symbol=mod.enclosing_function(call),
            detail="unguarded-spec-snapshot",
            message=f"{name}(...) takes the burst's rollback token with no "
                    f"rollback or recovery (spec_restore / verify_step / "
                    f"reset_slots / _recover_step_fault) on the raise "
                    f"path: a raise mid-burst strands the pool with the "
                    f"drafts' positions and no way back")]

    @staticmethod
    def _releases(try_node, names=registry.RELEASE_CALLS) -> bool:
        region = [s for h in try_node.handlers for s in h.body]
        region += try_node.finalbody
        return any(isinstance(n, ast.Call) and _call_name(n) in names
                   for stmt in region for n in ast.walk(stmt))


# ----------------------------------------------------------------- capture

class CaptureHazardRule(Rule):
    """Hazards for a step that is captured once and replayed."""

    name = "capture-hazard"

    _MUTABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                ast.SetComp)
    _TENSOR_ROOTS = ("torch", "np", "numpy")
    # containers in tensor-op args are shape metadata, nested calls own
    # their args, and dtype attributes are config scalars
    _SKIP_NODES = (ast.Call, ast.Tuple, ast.List, ast.Dict, ast.Set)
    _METADATA_ATTRS = ("dtype",)

    def __init__(self, extra_functions=None):
        self.extra_functions = dict(extra_functions or {})

    def check(self, mod):
        out = []
        hot = _hot_functions(mod, self.extra_functions)
        for node, qual in mod.functions():
            if node in hot:
                defaults = list(node.args.defaults) + [
                    d for d in node.args.kw_defaults if d is not None]
                out.extend(Finding(
                    rule=self.name, severity=Severity.ERROR, path=mod.path,
                    line=d.lineno, symbol=qual, detail="mutable-default",
                    message="mutable default argument on a hot-path "
                            "function: state shared across calls, and a "
                            "captured step records whatever the first "
                            "call saw")
                    for d in defaults if isinstance(d, self._MUTABLE))
            if self._is_lru_cached(node):
                out.extend(self._lru_tensor_args(mod, node, qual))
        return out

    @staticmethod
    def _is_lru_cached(fn) -> bool:
        for dec in fn.decorator_list:
            d = _dotted(dec.func if isinstance(dec, ast.Call) else dec)
            if d and d.split(".")[-1] in ("lru_cache", "cache"):
                return True
        return False

    def _lru_tensor_args(self, mod, fn, qual):
        params = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                  + fn.args.kwonlyargs)}
        for node in _walk_in_function(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if not d or d.split(".")[0] not in self._TENSOR_ROOTS:
                continue
            if d.split(".")[-1] in self._METADATA_ATTRS:
                continue
            stack = list(node.args) + [kw.value for kw in node.keywords]
            while stack:
                n = stack.pop()
                if isinstance(n, self._SKIP_NODES):
                    continue
                if not (isinstance(n, ast.Name) and n.id in params):
                    stack.extend(ast.iter_child_nodes(n))
                    continue
                return [Finding(
                    rule=self.name, severity=Severity.WARN, path=mod.path,
                    line=fn.lineno, symbol=qual,
                    detail="lru_cache-tensor-arg",
                    message=f"functools.lru_cache over {fn.name!r} whose "
                            f"parameter {n.id!r} flows into {d}: tensor-"
                            f"keyed memoization pins device buffers alive "
                            f"or hands one caller's buffer to the next")]
        return []


# ---------------------------------------------------------- engine contract

class EngineContractRule(Rule):
    """serve.py stays family-branch-free."""

    name = "engine-family-branch"

    def __init__(self, targets=None):
        self.targets = tuple(targets or registry.ENGINE_CONTRACT_FILES)

    def check(self, mod):
        if not _suffix_match(mod.path, self.targets):
            return []
        out = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and node.attr == "family":
                out.append(Finding(
                    rule=self.name, severity=Severity.ERROR, path=mod.path,
                    line=node.lineno, symbol=mod.enclosing_function(node),
                    detail=".family",
                    message="family attribute access in the engine: every "
                            "family-specific decision belongs behind the "
                            "DecodeState protocol"))
            if isinstance(node, ast.Name) and node.id in (
                    "NotImplementedError", "NotImplemented"):
                out.append(Finding(
                    rule=self.name, severity=Severity.ERROR, path=mod.path,
                    line=node.lineno, symbol=mod.enclosing_function(node),
                    detail=node.id,
                    message=f"{node.id} escape hatch in the engine: the "
                            f"slot engine must serve every family it "
                            f"admits"))
        return out


# ----------------------------------------------------------- silent fallback

def _is_host_gate(test) -> bool:
    """``<expr>.device.type == "cpu"``."""
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.left.value, ast.Attribute)
            and test.left.value.attr == "device"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == "cpu")


class FallbackContractRule(Rule):
    """Kernel-routing functions must not fall back silently."""

    name = "silent-fallback"

    def __init__(self, contracts=None):
        self.contracts = tuple(contracts or registry.FALLBACK_CONTRACTS)

    def check(self, mod):
        out = []
        for spec in self.contracts:
            if not _suffix_match(mod.path, (spec["path"],)):
                continue
            fn = next((node for node, q in mod.functions()
                       if q.split(".")[-1] == spec["function"]), None)
            if fn is not None:
                out.extend(self._check_fn(mod, fn, spec))
        return out

    def _finding(self, mod, node, qual, detail, message):
        return Finding(rule=self.name, severity=Severity.ERROR,
                       path=mod.path, line=node.lineno, symbol=qual,
                       detail=detail, message=message)

    def _host_routed(self, mod, fn, call) -> bool:
        """``call`` sits in the body of a device gate of ``fn``."""
        for anc in mod.ancestors(call):
            if anc is fn:
                return False
            if (isinstance(anc, ast.If) and _is_host_gate(anc.test)
                    and any(_contains(s, call) for s in anc.body)):
                return True
        return False

    def _check_fn(self, mod, fn, spec):
        out = []
        qual = mod.qualnames[fn]
        required = spec["require_call"]
        if not any(isinstance(n, ast.Call)
                   and (_dotted(n.func) or "").split(".")[-1] == required
                   for n in _walk_in_function(fn)):
            out.append(self._finding(
                mod, fn, qual, f"missing-{required}",
                f"{qual} no longer routes through {required}: the "
                f"kernel contract is gone"))
        forbid = set(spec.get("forbid_if_names", ()))
        for node in _walk_in_function(fn):
            if isinstance(node, ast.If):
                names = {n.id for n in ast.walk(node.test)
                         if isinstance(n, ast.Name)}
                for bad in sorted(names & forbid):
                    out.append(self._finding(
                        mod, node, qual, f"if-{bad}",
                        f"{qual} branches on {bad!r}: a configuration-"
                        f"gated route away from the kernel is a silent "
                        f"fallback"))
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func) or _call_name(node) or ""
            for sub in spec.get("forbid_call_substrings", ()):
                if sub in d and not (spec.get("host_gate")
                                     and self._host_routed(mod, fn, node)):
                    out.append(self._finding(
                        mod, node, qual, f"call-{sub}",
                        f"{qual} calls {d}: a plain or reference version "
                        f"must not be reachable from the kernel entry "
                        f"point except for a tensor on the CPU"))
        return out


# ------------------------------------------------------------------ runner

ALL_RULES = (HostSyncRule(), RefcountRule(), CaptureHazardRule(),
             EngineContractRule(), FallbackContractRule())


def _expand(paths):
    files = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__"
                                 and not d.startswith("."))
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    return files


def run_rules(paths, rules=None):
    """Run ``rules`` (default: the whole catalog) over ``paths`` (files
    or directories). Returns (findings, number of files)."""
    rules = list(ALL_RULES if rules is None else rules)
    findings = []
    files = _expand(paths)
    for path in files:
        try:
            mod = SourceModule.parse(path)
        except SyntaxError as e:
            findings.append(Finding(
                rule="parse-error", severity=Severity.ERROR, path=path,
                line=e.lineno or 0, symbol="", detail="syntax-error",
                message=f"cannot parse: {e.msg}"))
            continue
        for rule in rules:
            findings.extend(rule.check(mod))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.detail))
    return findings, len(files)
