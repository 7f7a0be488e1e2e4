"""ExecPolicy: one hashable object deciding numerics + kernels end to end.

Port of ``repro/runtime/policy.py`` restricted to the fields this slice
reads. Resolution precedence (highest wins):

    1. per-call overrides        resolve_policy(cfg, exp_backend="exact")
    2. environment variables     REPRO_EXP_BACKEND=vexp_hw ...
    3. model-config fields       cfg.exp_impl / cfg.kernel_backend / blocks
    4. library defaults          ExecPolicy()

Kernel tiers of the port:

    cuda       the hand-written Hopper kernels (``repro_torch.kernels``);
               on CPU tensors their plain versions run instead
    reference  plain blockwise torch (the FlashAttention scan)
    eager      materialized-score attention

``REPRO_KERNEL_BACKEND=pallas`` / ``xla`` mean ``cuda`` / ``eager``, so one
environment drives both packages.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, replace
from typing import Mapping, Optional

EXP_BACKENDS = ("exact", "vexp", "vexp_hw")
KERNEL_BACKENDS = ("cuda", "reference", "eager")
MERGE_STRATEGIES = ("packed", "split")
# names the reference package uses for the same tiers
BACKEND_ALIASES = {"pallas": "cuda", "xla": "eager"}

ENV_PREFIX = "REPRO_"
_ENV_FIELDS = {
    "EXP_BACKEND": "exp_backend",
    "KERNEL_BACKEND": "kernel_backend",
    "BLOCK_K": "block_k",
    "BLOCK_S": "block_s",
    "BLOCK_PAGE": "block_page",
    "ACCUM_DTYPE": "accum_dtype",
    "MERGE_STRATEGY": "merge_strategy",
}
_INT_FIELDS = ("block_k", "block_s", "block_page")


@dataclass(frozen=True)
class ExecPolicy:
    """How to execute the softmax/attention stack.

    exp_backend     "exact" | "vexp" | "vexp_hw" (core.vexp.EXP_FNS).
    kernel_backend  "cuda" | "reference" | "eager" (module docstring).
    block_k         FlashAttention KV block: the unit of the online
                    (m, l, acc) update, in the kernel and the scan. (The
                    kernel's 64-row query tile is not a policy choice.)
    block_s         decode-attention KV block (online-update unit).
    block_page      paged-KV page size in tokens: the paged pool's
                    allocation unit and the paged decode kernel's
                    online-update unit. Fixed when a pool is built.
    accum_dtype     "float32" only: the kernels keep (m, l, acc) in f32;
                    "bfloat16" scratch is not ported yet and raises.
    merge_strategy  how sequence-sharded decode folds the per-shard
                    softmax statistics: "packed" all_gathers one
                    contiguous [acc | m | l] tile (one collective per
                    merge) and folds it locally; "split" is all_reduce MAX
                    of m, then two all_reduce SUMs of the rescaled l and
                    acc (three collectives). The same algebra either way.
    """

    exp_backend: str = "vexp"
    kernel_backend: str = "cuda"
    block_k: int = 128
    block_s: int = 512
    block_page: int = 64
    accum_dtype: str = "float32"
    merge_strategy: str = "packed"

    def __post_init__(self):
        kb = BACKEND_ALIASES.get(self.kernel_backend, self.kernel_backend)
        object.__setattr__(self, "kernel_backend", kb)
        if self.exp_backend not in EXP_BACKENDS:
            raise ValueError(
                f"exp_backend {self.exp_backend!r} not in {EXP_BACKENDS}")
        if kb not in KERNEL_BACKENDS:
            raise ValueError(
                f"kernel_backend {kb!r} not in {KERNEL_BACKENDS}")
        if self.accum_dtype != "float32":
            raise ValueError(
                f"accum_dtype {self.accum_dtype!r} is not supported by the "
                f"port yet (float32 only)")
        if self.merge_strategy not in MERGE_STRATEGIES:
            raise ValueError(
                f"merge_strategy {self.merge_strategy!r} not in "
                f"{MERGE_STRATEGIES}")
        for f in _INT_FIELDS:
            v = getattr(self, f)
            if not (isinstance(v, int) and v > 0):
                raise ValueError(f"{f} must be a positive int, got {v!r}")

    def exp_fn(self):
        from repro_torch.core.vexp import get_exp_fn
        return get_exp_fn(self.exp_backend)

    def replace(self, **kw) -> "ExecPolicy":
        return replace(self, **kw)

    def describe(self) -> str:
        return (f"exp={self.exp_backend} kernel={self.kernel_backend} "
                f"blocks=(k{self.block_k},s{self.block_s},"
                f"p{self.block_page}) "
                f"accum={self.accum_dtype} merge={self.merge_strategy}")


def _parse(field: str, raw: str):
    if field in _INT_FIELDS:
        try:
            return int(raw)
        except ValueError:
            raise ValueError(f"env override for {field} must be an int, "
                             f"got {raw!r}") from None
    return raw.strip()


def policy_from_env(env: Optional[Mapping[str, str]] = None) -> dict:
    """Policy field overrides present in the environment."""
    env = os.environ if env is None else env
    out = {}
    for suffix, field in _ENV_FIELDS.items():
        raw = env.get(ENV_PREFIX + suffix)
        if raw:
            out[field] = _parse(field, raw)
    return out


def _config_fields(cfg) -> dict:
    out = {}
    if cfg.exp_impl:
        out["exp_backend"] = cfg.exp_impl
    if cfg.kernel_backend:
        out["kernel_backend"] = cfg.kernel_backend
    if cfg.attn_block_k:
        out["block_k"] = cfg.attn_block_k
    return out


def resolve_policy(cfg=None, *, env: Optional[Mapping[str, str]] = None,
                   base: Optional[ExecPolicy] = None,
                   **overrides) -> ExecPolicy:
    """Resolve the effective ExecPolicy: ``overrides`` > environment
    (pass ``env={}`` to ignore the process environment) > ``cfg`` fields >
    ``base`` (library defaults). Unknown override names raise."""
    fields = {f.name for f in dataclasses.fields(ExecPolicy)}
    bad = set(overrides) - fields
    if bad:
        raise ValueError(f"unknown policy override(s) {sorted(bad)}; "
                         f"valid: {sorted(fields)}")
    merged = dataclasses.asdict(base) if base is not None else {}
    if cfg is not None:
        merged.update(_config_fields(cfg))
    merged.update(policy_from_env(env))
    merged.update({k: v for k, v in overrides.items() if v is not None})
    return ExecPolicy(**merged)


def parse_policy_groups(spec: str, cfg=None, *,
                        base: Optional[ExecPolicy] = None,
                        env: Optional[Mapping[str, str]] = None) -> dict:
    """Parse ``name=exp_backend[/kernel_backend]`` entries joined by commas
    (e.g. ``"eval=exact,bulk=vexp"``) into named ExecPolicies. A ``base``
    is an already-resolved policy: ``cfg`` is then ignored and the process
    environment is not re-read unless ``env`` is passed explicitly."""
    if base is not None:
        cfg = None
        if env is None:
            env = {}
    groups = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.partition("=")
        name, val = name.strip(), val.strip()
        if not sep or not name or not val:
            raise ValueError(f"bad policy-group entry {part!r}; expected "
                             f"name=exp_backend[/kernel_backend]")
        if name in groups:
            raise ValueError(f"duplicate policy group {name!r}")
        exp, _, kb = val.partition("/")
        overrides = {"exp_backend": exp.strip()}
        if kb.strip():
            overrides["kernel_backend"] = kb.strip()
        groups[name] = resolve_policy(cfg, base=base, env=env, **overrides)
    if not groups:
        raise ValueError(f"empty policy-groups spec {spec!r}")
    return groups
