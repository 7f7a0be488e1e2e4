"""Hot-path registry: which code of the port the serving contracts bind
to (port of ``repro/analysis/registry.py``).

Two ways into the registry, both read at the AST level only (the
analyzer never imports what it analyzes):

* the ``@hot_path`` marker: an identity decorator on the decode-step
  functions and the engine's scheduling functions. The rule recognizes
  it by name (``hot_path`` / ``registry.hot_path``), so a planted source
  needs no import to be analyzable;
* ``HOT_PATH_FUNCTIONS``: qualname globs per path suffix, for the
  helpers the step calls in modules that do not import the marker (the
  kernel launch wrappers).

Marking discipline:

* **per-decode-step code** (``STEP_STRICT``: the engine's decode tick,
  the states' ``step``, ``transformer.decode_step*``, the graph's
  ``__call__`` / ``replay``, the decode launch wrappers) must lint clean
  and admits no baseline entry: a host sync there runs once per token,
  and breaks CUDA-graph capture outright;
* **scheduling-event code** (``_Group.admit``, ``_Group._finish``) is
  audited by the same rule; its one sync per event is by design and sits
  in ``baseline.toml`` with its reason, so a new sync there still fails.

Stdlib only: model modules import this module for the marker, and the
CLI runs without torch.
"""

from __future__ import annotations

_HOT_ATTR = "__repro_torch_hot_path__"


def hot_path(fn):
    """Mark ``fn`` as serving hot path for ``repro_torch.analysis``.

    Identity decorator: ``fn`` comes back unchanged apart from a marker
    attribute, so it keeps its source, signature and behavior."""
    try:
        setattr(fn, _HOT_ATTR, True)
    except (AttributeError, TypeError):      # builtins / partials
        pass
    return fn


def is_hot_path(fn) -> bool:
    return bool(getattr(fn, _HOT_ATTR, False))


# Qualname globs (fnmatch) of hot-path functions without the decorator,
# per path suffix: what the decode step runs inside a module that keeps
# no import of the marker.
HOT_PATH_FUNCTIONS = {
    "repro_torch/kernels/decode_attention.py": (
        "decode_attention", "decode_attention_paged", "_launch_*",
        "_lens", "_stat_outputs", "_ptrs", "_split_scratch",
    ),
    "repro_torch/models/transformer.py": (
        "_decode_layers", "_positions", "_live", "_write_token_kv",
        "_write_token_kv_paged", "_paged_coords", "_paged_attn",
        "_final_logits", "_chunk_lanes", "_chunk_layers", "_chunk_logits",
        "_chunk_all_logits",
        "_write_chunk_kv", "_write_chunk_kv_paged",
    ),
    "repro_torch/models/decode_state.py": ("_guard_tokens",),
}

# Per-decode-step symbols that must stay finding-free: a baseline entry
# covering one is rejected (exit 2). (path suffix, qualname glob).
STEP_STRICT = (
    ("repro_torch/launch/serve.py", "_Group.decode_once"),
    ("repro_torch/launch/serve.py", "_Group.decode_spec_once"),
    ("repro_torch/launch/serve.py", "Server.step"),
    ("repro_torch/models/decode_state.py", "*step"),
    ("repro_torch/models/decode_state.py", "*._logits"),
    ("repro_torch/models/decode_state.py", "*.carry"),
    ("repro_torch/models/decode_state.py", "_guard_tokens"),
    ("repro_torch/models/transformer.py", "decode_step*"),
    ("repro_torch/models/transformer.py", "prefill_chunk*"),
    ("repro_torch/models/decode_state.py", "*._chunk_*"),
    ("repro_torch/models/decode_state.py", "_spec_*"),
    ("repro_torch/models/decode_state.py", "*.spec_*"),
    ("repro_torch/models/decode_state.py", "*._draft"),
    ("repro_torch/runtime/graphs.py", "StepGraph.__call__"),
    ("repro_torch/runtime/graphs.py", "StepGraph.replay"),
    ("repro_torch/kernels/decode_attention.py", "decode_attention*"),
    ("repro_torch/kernels/decode_attention.py", "_launch_*"),
)

# Modules holding refcounted-page bookkeeping: the refcount-pairing rule
# (raw ``.refs`` mutation, unguarded allocation loops) applies here.
ALLOC_MODULES = (
    "repro_torch/models/block_pool.py",
    "repro_torch/models/decode_state.py",
)
# Methods allowed to touch ``.refs`` storage directly: the refcount
# primitives themselves plus construction and verification.
REFS_PRIMITIVES = ("incref", "decref", "_alloc_one", "__init__", "check")
# Call names that take a page reference (allocate or incref): a loop
# accumulating these needs a release-on-exception guard.
ALLOC_CALLS = ("_alloc_one", "alloc_cols", "incref", "attach")
# Call names that release page references (what a guard must reach).
RELEASE_CALLS = ("decref", "_evict_one", "drop_all", "release")
# Slot-reservation pairing in the engine: ``begin_chunk`` reserves a
# slot's pool state (pages, prefix references, table row) before the
# request is published into the in-flight map, so inside an admission
# loop a raise between the two must reach a slot release.
SLOT_MODULES = ("repro_torch/launch/serve.py",)
SLOT_RESERVE_CALLS = ("begin_chunk",)
SLOT_RELEASE_CALLS = ("abort_chunk", "reset_slots", "decref", "recover")
# Speculative-burst snapshot pairing: ``spec_snapshot`` hands the engine
# the burst's only rollback token before the draft steps advance the
# pool's positions in place, so a raise before the verify folds them
# back must reach a rollback or recovery call.
SPEC_SNAPSHOT_CALLS = ("spec_snapshot",)
SPEC_SNAPSHOT_RELEASES = ("spec_restore", "verify_step", "reset_slots",
                          "_recover_step_fault")

# The engine stays family-agnostic: no family branch, no not-implemented
# escape hatch.
ENGINE_CONTRACT_FILES = ("repro_torch/launch/serve.py",)

# Kernel-routing contracts. ``forbid_if_names``: names no If test in the
# function may read (a configuration-gated route away from the kernel);
# ``forbid_call_substrings``: calls that must not appear, except inside
# the body of an ``if <tensor>.device.type == "cpu":`` when ``host_gate``
# is set (the port's one legitimate route to a plain version: a tensor
# that lies on the CPU); ``require_call``: the call that must remain.
FALLBACK_CONTRACTS = (
    {
        "path": "repro_torch/kernels/decode_attention.py",
        "function": "decode_attention",
        "forbid_if_names": ("layout", "window", "cache_len"),
        "forbid_call_substrings": ("_plain", "_reference"),
        "host_gate": True,
        "require_call": "_launch_contig",
    },
    {
        "path": "repro_torch/kernels/decode_attention.py",
        "function": "decode_attention_paged",
        "forbid_if_names": ("layout", "window", "cache_len", "block_tab"),
        "forbid_call_substrings": ("_plain", "_reference"),
        "host_gate": True,
        "require_call": "_launch_paged",
    },
    {
        "path": "repro_torch/core/attention.py",
        "function": "decode_attention",
        "forbid_if_names": ("layout", "window", "cache_len"),
        "forbid_call_substrings": ("_plain", "_reference"),
        "require_call": "dispatch",
    },
)
