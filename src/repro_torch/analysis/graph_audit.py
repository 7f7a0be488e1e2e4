"""Audits of the decode step as it runs (imports torch): the port's
counterpart of ``repro/analysis/jaxpr_audit.py``, which reads the lowered
programs. Here the step is a CUDA graph over an in-place carry
(``runtime.graphs.StepGraph``), so the audits watch one step run:

* **collective budget**: the ``ShardGroup`` collectives one step issues,
  by kind, equal to a budget. Unsharded steps issue none; a sequence-
  sharded step issues one ``all_gather`` per layer ("packed") or one
  ``all_reduce`` MAX and two SUMs per layer ("split"): 12 or 36 a step
  at gpt2-small.
* **in-place carry** (the donation counterpart): every carry tensor
  (cache leaves, positions, block tables, input tokens, live mask, the
  output buffer) has the same storage pointer after the step as before.
  A rebound carry tensor leaves a captured graph reading the old one.
* **carry stability**: the carry keeps its names, shapes, dtypes and
  devices across the step.
* **burst buffers** (speculative decode): the decode carry and the
  burst buffers (``pos0``, ``toks``, ``rem``, ``block``, ``nlast``) keep
  their storage across a burst, as the decode carry does across a step:
  the draft steps and the verify are replays over them.
* **capture audit** (on the card only): the group's step was captured,
  and replaying it from a carry gives the same tokens and positions as
  the eager step from the same carry.

The reference's output-sharding audit checks its sharded chunk-prefill
program, which the port does not have yet.

Each audit raises a typed ``AuditError`` (an ``AssertionError``, so
pytest renders it).
"""

from __future__ import annotations

import torch

from repro_torch.runtime.graphs import carry_signature


class AuditError(AssertionError):
    """Base of the audit failures."""


class CollectiveBudgetError(AuditError):
    pass


class InPlaceCarryError(AuditError):
    pass


class CarryStabilityError(AuditError):
    pass


class CaptureError(AuditError):
    pass


# ------------------------------------------------------------- collectives

def collective_counts(step, comm) -> dict:
    """{kind: count} of the collectives ``comm`` (a ``ShardGroup``, or
    None for an unsharded step, which then issues none) sees during one
    call of ``step()``; kinds with no call are left out."""
    if comm is None:
        step()
        return {}
    before = dict(comm.kinds)
    step()
    return {k: n - before.get(k, 0) for k, n in comm.kinds.items()
            if n != before.get(k, 0)}


def budget_mismatch(got: dict, budget: dict) -> str | None:
    """Why ``got`` breaks ``budget`` (exact counts; kinds absent from the
    budget must not appear), or None."""
    want = {k: v for k, v in budget.items() if v}
    if got == want:
        return None
    return (f"the step issued {got or 'no collectives'}, its budget is "
            f"{want or 'none'}: a collective count per layer is part of "
            f"the serving contract")


def assert_collective_budget(step, comm, budget: dict) -> dict:
    """Run ``step()`` once and hold its collectives to ``budget``."""
    got = collective_counts(step, comm)
    why = budget_mismatch(got, budget)
    if why:
        raise CollectiveBudgetError(why)
    return got


def step_budget(n_layers: int, merge_strategy: str | None) -> dict:
    """A decode step's budget: none unsharded (None), one all_gather per
    layer packed, one all_reduce MAX and two SUMs per layer split."""
    if merge_strategy is None:
        return {}
    if merge_strategy == "packed":
        return {"all_gather": n_layers}
    return {"all_reduce_max": n_layers, "all_reduce_sum": 2 * n_layers}


# ------------------------------------------------------------------- carry

def carry_report(before: dict, after: dict) -> tuple:
    """(stability problems, in-place problems) between two
    ``carry_signature`` readings of one carry."""
    unstable, moved = [], []
    for name in sorted(before.keys() | after.keys()):
        if name not in before or name not in after:
            unstable.append(f"{name}: {'gone' if name in before else 'new'}"
                            f" after the step")
            continue
        (p0, *meta0), (p1, *meta1) = before[name], after[name]
        if meta0 != meta1:
            unstable.append(f"{name}: shape/dtype/device {tuple(meta0)} -> "
                            f"{tuple(meta1)}")
        elif p0 != p1:
            moved.append(f"{name}: storage {p0:#x} -> {p1:#x}")
    return unstable, moved


def assert_carry_kept(before: dict, after: dict) -> None:
    """Carry stability, then the in-place carry, between two readings."""
    unstable, moved = carry_report(before, after)
    if unstable:
        raise CarryStabilityError("carry changed across the step: "
                                  + "; ".join(unstable))
    if moved:
        raise InPlaceCarryError(
            "carry rebound instead of written in place (a captured step "
            "would read the old storage): " + "; ".join(moved))


def audit_step(state, last, live, step=None) -> dict:
    """Run one decode step of ``state`` (``step()``, by default
    ``state.step(last, live)``) and hold its carry in place and stable.
    Returns the carry's signature after the step."""
    before = carry_signature(state.carry(last, live))
    if step is None:
        state.step(last, live)
    else:
        step()
    after = carry_signature(state.carry(last, live))
    assert_carry_kept(before, after)
    return after


def burst_carry(state, last, live) -> dict:
    """Every tensor a speculative burst reads or writes, by name: the
    decode carry of the draft steps and the verify's burst buffers."""
    return {**state.carry(last, live), **state.spec_carry(live)}


def audit_burst(state, last, live, burst) -> dict:
    """Run one speculative burst (``burst()``) and hold the decode carry
    and the burst buffers in place and stable. Returns their signature
    after the burst."""
    before = carry_signature(burst_carry(state, last, live))
    burst()
    after = carry_signature(burst_carry(state, last, live))
    assert_carry_kept(before, after)
    return after


# ----------------------------------------------------------------- capture

def capture_audit(state, last, live) -> dict:
    """On the card: ``state``'s step is a captured graph, and its replay
    from a carry gives the eager step's tokens and positions from the
    same carry. Positions and tokens are put back afterwards; the cache
    rows the two runs wrote at each live slot's position are the rows
    the group's next step writes again from the same inputs. Returns the
    readings; raises CaptureError on a difference."""
    if state.device.type != "cuda":
        raise ValueError("the capture audit needs the card: on the CPU "
                         "the step always runs eagerly")
    graph = state.graph
    if graph is None or graph.graph is None:
        raise CaptureError("no captured step: the state is sharded, runs "
                           "eagerly, or has not stepped since its cache "
                           "was allocated")
    c = state.carry(last, live)
    saved = {k: c[k].clone() for k in ("pos", "out")}
    state._step(c)                               # eager
    eager = {k: c[k].clone() for k in saved}
    for k, t in saved.items():
        c[k].copy_(t)
    replays = graph.replays
    graph(state._step, c)                        # replay
    torch.cuda.synchronize(state.device)
    if graph.replays != replays + 1:
        raise CaptureError("the step did not run as a replay")
    replay = {k: c[k].clone() for k in saved}
    for k, t in saved.items():
        c[k].copy_(t)
    bad = [k for k in saved if not torch.equal(eager[k], replay[k])]
    if bad:
        rows = (eager["out"] != replay["out"]).reshape(-1).nonzero()
        raise CaptureError(f"replay differs from the eager step in {bad} "
                           f"(token rows {rows.reshape(-1).tolist()})")
    return {"captures": graph.captures, "live_slots": int(live.sum()),
            "tokens_equal": True, "positions_equal": True,
            "launches_per_replay": dict(graph.launches)}
