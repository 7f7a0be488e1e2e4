"""The hybrid family through the port's slot engine (reduced
recurrentgemma-9b on the CPU: window 16): ``HybridDecodeState`` and
``PagedHybridDecodeState`` under ``Server``. The port's own identities,
not comparisons with the JAX package.

* Batched == solo at the fixed admission width (the window): mixed
  lengths, and requests admitted into slots freed mid-decode, emit the
  tokens each request emits served alone, with decode running past the
  window so every ring wraps. A freed slot's recurrent rows are zero.
* Paged == contiguous: ring tables of 8-token pages, two pages a slot,
  against the contiguous ring with the same online-update block (the
  policy's ``block_s`` at the page), so both compute one function.
* Chunked == monolithic: chunk width 8 emits the monolithic tokens. The
  RG-LRU's combine tree spans the chunk, not the window, so the two are
  not bitwise equal; on these inputs every token is.
* Speculative == plain: the "recurrent" scan verify on the contiguous
  ring and "recurrent_paged" on the paged one, drafts under vexp_hw, and
  ``spec_restore`` puts the whole mixed state back bit for bit.
* Dead rows: a decode step over a pool with parked rows, and a chunk with
  inert rows, leaves their recurrent rows and ring rows bit for bit.
* Paged pages: no page leaked after a cancel mid-decode or an admission
  fault; a wave that does not fit the page budget holds nothing after
  its OutOfBlocks.
* Routing: ``decode_state_for``, ``api._mod``, the config registry; no
  entry point runs on the CPU unless asked to.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.ft import FaultInjector  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import api, hybrid  # noqa: E402
from repro_torch.models.block_pool import OutOfBlocks  # noqa: E402
from repro_torch.models.decode_state import (  # noqa: E402
    HybridDecodeState, PagedHybridDecodeState, decode_state_for)
from repro_torch.runtime import resolve_policy  # noqa: E402

LENS = (9, 16, 4, 13, 7)
MAX_NEW = 14                 # prompt + 14 > 16: every ring wraps
PAGE = 8


@pytest.fixture(scope="module")
def cfg():
    return get_config("recurrentgemma-9b").reduced()


@pytest.fixture(scope="module")
def params(cfg):
    return api.init_params(cfg, 0, device="cpu")


def _pol(cfg, **kw):
    kw.setdefault("block_page", PAGE)
    kw.setdefault("block_s", PAGE)
    return resolve_policy(cfg, env={}, kernel_backend="cuda", **kw)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _serve(cfg, params, prompts, *, max_new=MAX_NEW, max_batch=3,
           policy=None, **kw):
    srv = Server(cfg, params, max_batch=max_batch, max_seq=64,
                 policy=policy or _pol(cfg), device="cpu", **kw)
    reqs = [Request(i, p.copy(), max_new) for i, p in enumerate(prompts)]
    srv.run(reqs)
    srv.assert_idle_clean()
    return reqs, srv


_SOLO: dict = {}


def _solo(cfg, params, prompts, exp="vexp"):
    key = (tuple(len(p) for p in prompts), exp)
    if key not in _SOLO:
        _SOLO[key] = [_serve(cfg, params, [p], max_batch=1,
                             policy=_pol(cfg, exp_backend=exp))[0][0].out
                      for p in prompts]
    return _SOLO[key]


def _rec_rows_zero(state, slots):
    return all(not state.data[n][ax.batch * (slice(None),) + (j,)].any()
               for n, ax in state.axes.items() if ax.seq is None
               for j in slots)


# ------------------------------------------------------- batched == solo

@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_batched_equals_solo_and_freed_slots_zeroed(cfg, params, paged):
    """Five requests through three slots (two admitted into slots freed
    mid-decode), each decoding past the window: every request's tokens
    equal its solo run's (contiguous and paged), and every freed slot's
    recurrent rows are zero."""
    prompts = _prompts(cfg, LENS)
    solo = _solo(cfg, params, prompts)
    reqs, srv = _serve(cfg, params, prompts, paged=paged)
    assert [r.out for r in reqs] == solo
    assert all(r.finish_reason == "max_new" for r in reqs)
    g = srv._groups["default"]
    assert isinstance(g.state, PagedHybridDecodeState if paged
                      else HybridDecodeState)
    assert g.state.max_len() is None
    assert srv.stats()["default"]["admit_waves"] >= 2
    assert _rec_rows_zero(g.state, range(3))
    if paged:
        assert g.state.alloc.n_used() == 0
        assert not g.state.tables.any()


def test_pool_narrower_than_the_window_is_capped(cfg, params):
    """A pool narrower than the window cannot wrap its ring: it stops a
    slot at its capacity, as a linear cache does."""
    small = dataclasses.replace(cfg, sliding_window=32)
    srv = Server(small, params, max_batch=1, max_seq=20,
                 policy=_pol(small), device="cpu")
    st = srv._groups["default"].state
    assert st.cache_s == 20 and st.max_len() == 20
    r = Request(0, _prompts(small, (12,))[0], 30)
    srv.run([r])
    assert r.finish_reason == "length_cap" and len(r.out) <= 20 - 12 + 1


# ------------------------------------------------------ chunked prefill

@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_chunked_equals_monolithic(cfg, params, paged):
    prompts = _prompts(cfg, LENS, seed=1)
    mono, _ = _serve(cfg, params, prompts, paged=paged)
    reqs, srv = _serve(cfg, params, prompts, paged=paged,
                       policy=_pol(cfg, prefill_chunk=8))
    st = srv.stats()["default"]
    assert st["prefill_chunk"] == 8 and st["prefill_chunks"] >= 3
    assert [r.out for r in reqs] == [r.out for r in mono]


# ------------------------------------------------------- paged == ring

@pytest.mark.parametrize("exp", ["exact", "vexp_hw"])
def test_paged_equals_contiguous(cfg, params, exp):
    prompts = _prompts(cfg, LENS, seed=2)
    pol = _pol(cfg, exp_backend=exp)
    ring, _ = _serve(cfg, params, prompts, policy=pol)
    paged, srv = _serve(cfg, params, prompts, policy=pol, paged=True)
    assert [r.out for r in paged] == [r.out for r in ring]
    pool = srv._groups["default"].state.pool_stats()
    assert pool["pages_total"] == 1 + 3 * 2 and pool["pages_used"] == 0


# ------------------------------------------------ speculative == plain

@pytest.mark.parametrize("paged", [False, True], ids=["recurrent",
                                                      "recurrent_paged"])
def test_speculative_equals_plain(cfg, params, paged):
    prompts = _prompts(cfg, LENS[:3], seed=3)
    groups = {"eval": _pol(cfg, exp_backend="exact", spec_k=4),
              "hw": _pol(cfg, exp_backend="vexp_hw", spec_k=4)}
    plain_groups = {k: p.replace(spec_k=0) for k, p in groups.items()}

    def serve(gs):
        srv = Server(cfg, params, max_batch=2, max_seq=64,
                     policy=gs["eval"], policy_groups=gs, device="cpu",
                     paged=paged)
        reqs = [Request(i, p.copy(), 10, group=("eval", "hw")[i % 2])
                for i, p in enumerate(prompts)]
        srv.run(reqs)
        srv.assert_idle_clean()
        return reqs, srv

    plain, _ = serve(plain_groups)
    spec, srv = serve(groups)
    assert [r.out for r in spec] == [r.out for r in plain]
    st = srv._groups["hw"].state
    assert st._spec_mode() == ("recurrent_paged" if paged else "recurrent")
    assert srv.stats()["hw"]["spec_bursts"] > 0


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_spec_restore_puts_the_mixed_state_back(cfg, params, paged):
    """A burst's drafts write the recurrent rows and the ring;
    ``spec_restore`` copies the snapshot back bit for bit."""
    srv = Server(cfg, params, max_batch=2, max_seq=64,
                 policy=_pol(cfg, spec_k=3), device="cpu", paged=paged)
    g = srv._groups["default"]
    for i, p in enumerate(_prompts(cfg, (12, 6), seed=4)):
        srv.submit(Request(i, p, 20))
    srv.step()
    st = g.state
    before = {n: t.clone() for n, t in st.data.items()}
    pos = st.pos_dev.clone()
    snap = st.spec_snapshot(g.last)
    for _ in range(3):
        st.draft_step(g.last, g.live_dev)
    assert any(not torch.equal(before[n], t) for n, t in st.data.items())
    st.spec_restore(snap)
    assert all(torch.equal(before[n], t) for n, t in st.data.items())
    assert torch.equal(st.pos_dev, pos)


# ------------------------------------------------------------ dead rows

@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_dead_rows_keep_their_state(cfg, params, paged):
    """A step with row 1 parked, then a chunk in which only row 0 holds
    tokens: row 1's recurrent rows and its ring rows stay bit for bit."""
    cls = PagedHybridDecodeState if paged else HybridDecodeState
    pol = _pol(cfg)
    st = cls(cfg, params, pol, 2, 16, device=torch.device("cpu"))
    toks = np.zeros((2, 16), np.int32)
    toks[:, :10] = _prompts(cfg, (10, 10), seed=5)
    st.prefill_into([0, 1], toks, np.array([10, 10], np.int32))

    def row1():
        out = {}
        for n, ax in st.axes.items():
            t = st.data[n]
            if ax.seq is None:
                out[n] = t[ax.batch * (slice(None),) + (1,)].clone()
            elif paged:
                out[n] = t[:, st.tables[1].long()].clone()
            else:
                out[n] = t[:, 1].clone()
        return out

    kept = row1()
    last = torch.tensor([[3], [4]], dtype=torch.int32)
    live = torch.tensor([1, 0], dtype=torch.int32)
    st.step(last, live)
    after = row1()
    assert all(torch.equal(kept[n], after[n]) for n in kept)
    assert int(st.pos_dev[1]) == 10
    st.prefill_chunk_into(np.ones((2, 8), np.int32),
                          np.array([11, 0], np.int32),
                          np.array([3, 0], np.int32))
    after = row1()
    assert all(torch.equal(kept[n], after[n]) for n in kept)


# -------------------------------------------------------------- pages

def test_paged_cancel_and_admission_fault_leak_nothing(cfg, params):
    prompts = _prompts(cfg, LENS, seed=6)
    inj = FaultInjector(seed=0, schedule={"admit.out_of_blocks": [0]})
    srv = Server(cfg, params, max_batch=2, max_seq=64, policy=_pol(cfg),
                 device="cpu", paged=True, injector=inj)
    reqs = [Request(i, p.copy(), MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    for _ in range(3):
        srv.step()
    assert srv.cancel(reqs[0].rid)
    srv.drain()
    assert reqs[0].finish_reason == "cancelled"
    assert all(r.finish_reason == "max_new" for r in reqs[1:])
    srv.assert_idle_clean()
    srv._groups["default"].state.check_integrity(())


def test_wave_allocation_is_all_or_nothing(cfg, params):
    """A budget of one ring: a two-row wave raises OutOfBlocks holding no
    page; the engine then serves the requests one at a time."""
    st = PagedHybridDecodeState(cfg, params, _pol(cfg), 2, 16,
                                device=torch.device("cpu"), n_pages=3)
    toks = np.zeros((2, 16), np.int32)
    with pytest.raises(OutOfBlocks):
        st.prefill_into([0, 1], toks, np.array([5, 5], np.int32))
    assert st.alloc.n_used() == 0 and not st.tables.any()
    st.check_integrity(())
    prompts = _prompts(cfg, (5, 9), seed=7)
    reqs, srv = _serve(cfg, params, prompts, max_batch=2, paged=True,
                       block_budget=3)
    assert [r.out for r in reqs] == _solo(cfg, params, prompts)


# -------------------------------------------------------------- routing

def test_routing(cfg, params, monkeypatch):
    full = REGISTRY["recurrentgemma-9b"]
    assert (full.n_layers, full.d_model, full.hd, full.n_kv_heads,
            full.sliding_window, full.lru_width) == (38, 4096, 256, 1, 2048,
                                                     4096)
    assert hybrid.period_counts(full) == (3, 12, 2)
    assert (cfg.n_layers, cfg.lru_width, cfg.sliding_window) == (4, 128, 16)
    assert decode_state_for(full) is HybridDecodeState
    assert decode_state_for(full, paged=True) is PagedHybridDecodeState
    assert api._mod(cfg) is hybrid
    assert hybrid.gate_exps_per_step(full) == 104
    with pytest.raises(ValueError, match="history"):
        api.prefill(params, cfg, {"tokens": np.zeros((1, 4), np.int32),
                                "hist": {}}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception):
        api.init_params(cfg, 0)
