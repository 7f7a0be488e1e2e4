"""Paged KV serving in the port, held to the JAX package and to itself.

* ``repro_torch.models.block_pool``: the allocator and prefix-cache
  properties of ``tests/test_paged_pool.py`` (refcount storms through the
  hypothesis shim), plus one trace driven through both packages'
  allocators that must hand out the same page ids.
* The paged decode kernel's plain version against the Pallas
  ``decode_attention_kernel_paged`` in interpret mode (both layouts, every
  exp backend) and against the ``paged_gather`` oracle.
* ``decode_step_paged`` and ``prefill(hist=)`` against the JAX package's,
  logits within LOGIT_TOL as ``test_torch_model.py`` holds them.
* The port's own identities: paged == contiguous tokens, hot prefix ==
  cold solo, hot admission in the middle of decode, a wave re-queued on
  OutOfBlocks with no page leaked, ``assert_idle_clean`` after a drain,
  and one token check against the JAX paged ``Server``.

Tolerances: attention outputs as in ``test_torch_attention.py`` (2^-7:
f32 math, one bf16 rounding, different summation orders); logits 0.02
(bf16 activations rounded at different places by the two frameworks).
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import block_pool as jpool  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import block_pool as tpool  # noqa: E402
from repro_torch.models.block_pool import (BlockAllocator,  # noqa: E402
                                           BlockPoolError, OutOfBlocks,
                                           PrefixCache)
from repro_torch.runtime import ExecPolicy, resolve_policy  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
TOL = dict(atol=2.0 ** -7, rtol=2.0 ** -7)
LOGIT_TOL = 0.02


class _Injector:
    """Seeded stand-in for the fault injector the allocator consults:
    ``fire(point)`` is true with the point's rate."""

    def __init__(self, seed, rates):
        self.rng = np.random.default_rng(seed)
        self.rates = rates

    def fire(self, point):
        rate = self.rates.get(point, 0.0)
        return bool(rate) and bool(self.rng.random() < rate)


def _prompt(rng, n):
    return rng.integers(0, 997, (n,), dtype=np.int32)


# ---------------------------------------------------------------- allocator

@settings(max_examples=25, deadline=None)
@given(st.integers(2, 24), st.integers(0, 2 ** 31 - 1))
def test_alloc_free_roundtrip_any_trace(per_part, seed):
    """A random alloc/incref/decref trace keeps refcounts equal to the
    references held, and releasing them all frees the pool."""
    rng = np.random.default_rng(seed)
    alloc = BlockAllocator(per_part)
    held = []
    for _ in range(60):
        op = rng.integers(0, 3)
        if op == 0:
            try:
                held.append(alloc.alloc_cols([0])[0])
            except OutOfBlocks:
                assert alloc.n_free() == 0
        elif op == 1 and held:
            gid = held[int(rng.integers(len(held)))]
            alloc.incref(gid)
            held.append(gid)
        elif op == 2 and held:
            alloc.decref(held.pop(int(rng.integers(len(held)))))
        alloc.check()
        for g in set(held):
            assert alloc.refcount(g) == held.count(g)
    for gid in held:
        alloc.decref(gid)
    alloc.check()
    assert alloc.n_free() == per_part - 1 and alloc.n_used() == 0


def test_double_free_scratch_and_unallocated_raise():
    alloc = BlockAllocator(4)
    gid = alloc.alloc_cols([0])[0]
    alloc.decref(gid)
    for bad in (lambda: alloc.decref(gid),             # double free
                lambda: alloc.decref(alloc.scratch_id()),
                lambda: alloc.incref(gid)):            # unallocated
        with pytest.raises(BlockPoolError):
            bad()
    alloc.check()


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 6), st.integers(1, 4))
def test_partitioned_alloc_cols_respects_ownership(per_part, n_parts):
    alloc = BlockAllocator(per_part * n_parts, n_partitions=n_parts,
                           cols_per_part=3)
    cols = list(range(n_parts * 3))
    if alloc.can_alloc_cols(cols):
        got = alloc.alloc_cols(cols)
        for c, gid in zip(cols, got):
            assert alloc.part_of(gid) == c // 3
        for gid in got:
            alloc.decref(gid)
    free0 = int(alloc.free_counts()[0])
    with pytest.raises(OutOfBlocks):
        alloc.alloc_cols([0] * (free0 + 1))
    assert int(alloc.free_counts()[0]) == free0      # all or nothing
    alloc.check()


@settings(max_examples=20, deadline=None)
@given(st.integers(3, 16), st.integers(2, 5))
def test_cow_never_touches_the_shared_page(per_part, sharers):
    alloc = BlockAllocator(per_part)
    gid = alloc.alloc_cols([0])[0]
    for _ in range(sharers - 1):
        alloc.incref(gid)
    new = alloc.cow(gid)
    assert new != gid and alloc.refcount(gid) == sharers - 1
    assert alloc.refcount(new) == 1 and alloc.cow(new) == new
    alloc.check()


def test_cow_under_eviction_pressure_frees_last_ref():
    page, rng = 4, np.random.default_rng(2)
    alloc = BlockAllocator(3)
    cache = PrefixCache(alloc, page)
    g, x = _prompt(rng, page), _prompt(rng, page)
    gid_g = alloc.alloc_cols([0])[0]
    cache.insert(g, 0, gid_g)
    gid_x = alloc.alloc_cols([0])[0]
    cache.insert(x, 0, gid_x)
    alloc.decref(gid_x)
    new = alloc.cow(gid_g)            # eviction drops the cache's ref on g
    assert new == gid_x and alloc.refcount(gid_g) == 0
    alloc.decref(new)
    alloc.check()
    assert alloc.n_free() == 2 and alloc.n_used() == 0


# ------------------------------------------------------------- prefix cache

@settings(max_examples=20, deadline=None)
@given(st.integers(2, 8), st.integers(0, 2 ** 31 - 1))
def test_prefix_cache_probe_attach_insert(page, seed):
    rng = np.random.default_rng(seed)
    alloc = BlockAllocator(64)
    cache = PrefixCache(alloc, page)
    prompt = _prompt(rng, page * 3 + page // 2)
    gids = alloc.alloc_cols(range(4))
    for i in range(3):
        assert cache.insert(prompt, i, gids[i])
    assert cache.probe(prompt) == 3
    assert cache.attach(prompt) == gids[:3]
    assert all(alloc.refcount(g) == 3 for g in gids[:3])
    fork = prompt.copy()
    fork[page + 1] = (fork[page + 1] + 1) % 997
    assert cache.probe(fork) == 1 and cache.attach(fork) == gids[:1]
    before = alloc.refcount(gids[0])
    assert not cache.insert(prompt, 0, gids[0])
    assert alloc.refcount(gids[0]) == before
    alloc.check()


def test_prefix_cache_eviction_is_lru_leaf_first():
    page, rng = 4, np.random.default_rng(0)
    alloc = BlockAllocator(8)
    cache = PrefixCache(alloc, page)
    a, b = _prompt(rng, page * 2), _prompt(rng, page * 2)
    ga, gb = alloc.alloc_cols(range(2)), alloc.alloc_cols(range(2))
    for i in range(2):
        cache.insert(a, i, ga[i])
        cache.insert(b, i, gb[i])
    cache.attach(a)
    for g in ga + gb:
        alloc.decref(g)
    got = alloc.alloc_cols(range(4))
    assert cache.evictions == 1 and cache.probe(b) == 1
    got += alloc.alloc_cols([0])
    assert cache.probe(b) == 0 and cache.probe(a) == 2
    with pytest.raises(OutOfBlocks):
        alloc.alloc_cols([0])
    assert all(alloc.refcount(g) == 1 for g in ga)     # live refs survive
    for g in got + ga:
        alloc.decref(g)
    alloc.check()
    assert alloc.n_free() == 7


def test_partitioned_eviction_stays_with_chains_that_reach_the_partition():
    page, rng = 4, np.random.default_rng(3)
    alloc = BlockAllocator(8, n_partitions=2, cols_per_part=3)
    cache = PrefixCache(alloc, page)
    p = _prompt(rng, page * 2)                # confined to partition 0
    gids = alloc.alloc_cols([0, 1])
    for i in range(2):
        cache.insert(p, i, gids[i])
    for g in gids:
        alloc.decref(g)
    held = alloc.alloc_cols([3, 4, 5])
    with pytest.raises(OutOfBlocks):
        alloc.alloc_cols([3])
    assert cache.probe(p) == 2, "unrelated chain was drained"
    for g in held:
        alloc.decref(g)
    cache.drop_all()
    q = _prompt(rng, page * 4)                # spans both partitions
    gids = alloc.alloc_cols([0, 1, 2, 3])
    for i in range(4):
        cache.insert(q, i, gids[i])
    for g in gids:
        alloc.decref(g)
    got = alloc.alloc_cols([0])
    assert alloc.part_of(got[0]) == 0 and cache.probe(q) == 2
    alloc.decref(got[0])
    cache.drop_all()
    alloc.check()
    assert alloc.n_used() == 0


# ------------------------------------------------------------ refcount storms

def _held_counts(held):
    counts = {}
    for gids in held:
        for g in gids:
            counts[g] = counts.get(g, 0) + 1
    return counts


def _assert_conserved(alloc, cache, held):
    alloc.check()
    holds = _held_counts(held)
    cached = {}
    for gid, _, _ in cache._entries.values():
        cached[gid] = cached.get(gid, 0) + 1
    for g in set(holds) | set(cached):
        assert alloc.refcount(g) == holds.get(g, 0) + cached.get(g, 0)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(8, 32))
def test_refcount_storm_conserves_refcounts(seed, n_pages):
    """Random admit / share / cow / release traffic with forced
    OutOfBlocks and dropped cache chains: after every op each page's
    refcount is exactly slot holds + cache holds; nothing leaks."""
    rng = np.random.default_rng(seed)
    inj = _Injector(seed, {"alloc.out_of_blocks": 0.15})
    page = 4
    alloc = BlockAllocator(n_pages)
    alloc.injector = inj
    cache = PrefixCache(alloc, page)
    prompts = [_prompt(rng, page * int(rng.integers(1, 5)))
               for _ in range(5)]
    held = []
    for _ in range(80):
        op = int(rng.integers(0, 5))
        if op == 0:                    # admit: pin hits, then allocate
            p = prompts[int(rng.integers(len(prompts)))]
            n_full = len(p) // page
            h = cache.probe(p)
            got = cache.attach(p, max_pages=h)
            try:
                fresh = alloc.alloc_cols(range(h, n_full))
            except OutOfBlocks:
                for g in got:
                    alloc.decref(g)
            else:
                gids = got + fresh
                for i in range(h, n_full):
                    if cache.probe(p) >= i:
                        cache.insert(p, i, gids[i])
                held.append(gids)
        elif op == 1 and held:
            for g in held.pop(int(rng.integers(len(held)))):
                alloc.decref(g)
        elif op == 2 and held:
            slot = held[int(rng.integers(len(held)))]
            k = int(rng.integers(len(slot)))
            try:
                slot[k] = alloc.cow(slot[k])
            except OutOfBlocks:
                pass
        elif op == 3:
            cache.invalidate(n=1 + int(rng.integers(3)), rng=rng)
        _assert_conserved(alloc, cache, held)
    for gids in held:
        for g in gids:
            alloc.decref(g)
    cache.drop_all()
    alloc.check()
    assert alloc.n_used() == 0 and alloc.n_free() == n_pages - 1


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_refcount_storm_partitioned_pool(seed):
    rng = np.random.default_rng(seed)
    alloc = BlockAllocator(24, n_partitions=2, cols_per_part=3)
    alloc.injector = _Injector(seed, {"alloc.out_of_blocks": 0.2})
    held = []
    for _ in range(60):
        if int(rng.integers(0, 2)) == 0:
            cols = list(range(int(rng.integers(1, 6))))
            before = alloc.free_counts().copy()
            try:
                held.append(alloc.alloc_cols(cols))
            except OutOfBlocks:
                assert (alloc.free_counts() == before).all()
        elif held:
            for g in held.pop(int(rng.integers(len(held)))):
                alloc.decref(g)
        alloc.check()
    for gids in held:
        for g in gids:
            alloc.decref(g)
    assert alloc.n_used() == 0


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_same_page_ids_as_the_jax_package(seed):
    """One random trace of admissions (probe, attach, allocate, insert),
    releases and evictions under pressure, driven through both packages'
    allocators and prefix caches: every call hands out the same page ids
    and the two pools end in the same state."""
    rng = np.random.default_rng(seed)
    page = 4
    pools = []
    for mod in (jpool, tpool):
        alloc = mod.BlockAllocator(20)
        pools.append((mod, alloc, mod.PrefixCache(alloc, page)))
    prompts = [_prompt(rng, page * int(rng.integers(1, 5)))
               for _ in range(6)]
    held = [[] for _ in pools]
    for _ in range(60):
        op = int(rng.integers(0, 3))
        p = prompts[int(rng.integers(len(prompts)))]
        pick = int(rng.integers(1 << 30))
        outs = []
        for (mod, alloc, cache), hl in zip(pools, held):
            if op < 2:
                h = cache.probe(p)
                got = cache.attach(p, max_pages=h)
                try:
                    fresh = alloc.alloc_cols(range(h, len(p) // page + 1))
                except mod.OutOfBlocks:
                    for g in got:
                        alloc.decref(g)
                    outs.append(("oob", h))
                    continue
                for i in range(h, len(p) // page):
                    cache.insert(p, i, (got + fresh)[i])
                hl.append(got + fresh)
                outs.append(("ok", got + fresh))
            elif hl:
                gids = hl.pop(pick % len(hl))
                for g in gids:
                    alloc.decref(g)
                outs.append(("free", gids))
        assert outs[:1] == outs[1:]
    (_, ja, jc), (_, ta, tc) = pools
    assert ja.refs.tolist() == ta.refs.tolist()
    assert sorted(jc._entries.values()) == sorted(tc._entries.values())
    assert (jc.hits, jc.misses, jc.evictions) == \
        (tc.hits, tc.misses, tc.evictions)


# ------------------------------------------------------- paged decode kernel

def _bf(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _jbf(x):
    return jnp.asarray(x, jnp.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def paged_inputs():
    """b=3, h=8, hkv=4, d=32, page=16, nS=4: ragged lengths, a shuffled
    table without aliases, pools for both layouts."""
    b, h, hkv, d, page, ns = 3, 8, 4, 32, 16, 4
    n = 1 + b * ns
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kp = rng.standard_normal((n, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n, page, hkv, d)).astype(np.float32)
    tab = rng.permutation(np.arange(1, n))[:b * ns].reshape(b, ns)
    clen = np.array([1, page * 2 + 3, page * ns], np.int32)
    pools = {"bshd": (kp, vp),
             "bhsd": (kp.transpose(0, 2, 1, 3).copy(),
                      vp.transpose(0, 2, 1, 3).copy())}
    return q, pools, tab.astype(np.int32), clen


# Largest share of bf16 outputs whose bits may differ from the Pallas
# paged sweep. Updating once per page, the plain version matches it bit
# for bit under exact and vexp and moves 1 output of 768 under vexp_hw;
# an update per half page (or per two pages) moves 11-18 % of them. Under
# vexp such a wrong partition moves each output by at most 2^-8, inside
# TOL, so only the share can see it.
PAGED_BITS_SHARE = 2.0 ** -8

_PALLAS_PAGED = {}


def _pallas_paged(paged_inputs, layout, exp):
    """The Pallas paged sweep in interpret mode (computed once per case)."""
    if (layout, exp) not in _PALLAS_PAGED:
        from repro.kernels.decode_attention.ops import decode_attention_paged
        from repro.runtime import ExecPolicy as JaxPolicy
        q, pools, tab, clen = paged_inputs
        kp, vp = pools[layout]
        want = decode_attention_paged(
            _jbf(q), _jbf(kp), _jbf(vp), jnp.asarray(tab), jnp.asarray(clen),
            layout=layout, interpret=True,
            policy=JaxPolicy(exp_backend=exp, kernel_backend="pallas",
                             interpret=True))
        _PALLAS_PAGED[layout, exp] = torch.from_numpy(_np(want)).to(
            torch.bfloat16)
    return _PALLAS_PAGED[layout, exp]


def _bits_share(got, want):
    """Share of bf16 outputs whose bits differ."""
    return float((got.view(torch.int16) != want.view(torch.int16))
                 .double().mean())


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("exp", EXPS)
def test_paged_plain_matches_pallas_interpret(paged_inputs, layout, exp):
    """The paged kernel's plain version (online update once per page)
    against the Pallas paged sweep run in interpret mode: within TOL, and
    at most PAGED_BITS_SHARE of the outputs differ in any bit."""
    q, pools, tab, clen = paged_inputs
    kp, vp = pools[layout]
    want = _pallas_paged(paged_inputs, layout, exp)
    got = kdec.decode_attention_paged(
        _bf(q), _bf(kp), _bf(vp), torch.from_numpy(tab),
        torch.from_numpy(clen), layout=layout,
        policy=ExecPolicy(exp_backend=exp))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert _bits_share(got, want) <= PAGED_BITS_SHARE


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("exp", EXPS)
def test_paged_plain_at_half_a_page_fails_the_bits_share(paged_inputs,
                                                        layout, exp):
    """The plain version updating once per half page (the contiguous
    kernel's habit of a smaller block) leaves the Pallas sweep's
    partition: the bits share must reject it, under vexp too, where the
    largest difference stays inside TOL."""
    q, pools, tab, clen = paged_inputs
    kp, vp = pools[layout]
    want = _pallas_paged(paged_inputs, layout, exp)
    page = kp.shape[1] if layout == "bshd" else kp.shape[2]
    half = kdec.decode_attention_paged_plain(
        _bf(q), _bf(kp), _bf(vp), torch.from_numpy(tab),
        torch.from_numpy(clen), layout=layout, exp_backend=exp,
        block=page // 2)
    assert _bits_share(half, want) > PAGED_BITS_SHARE


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_paged_gather_and_reference_tier_match_jax(paged_inputs, layout):
    """``paged_gather`` equals the JAX one bit for bit; the reference
    tier (gather, then the one-pass decode) matches the JAX oracle, and
    the plain version stays within tolerance of it."""
    from repro.core.attention import decode_attention as jdecode
    from repro.kernels.decode_attention.ops import paged_gather as jgather
    from repro_torch.kernels.dispatch import dispatch
    q, pools, tab, clen = paged_inputs
    kp, vp = pools[layout]
    for pool in (kp, vp):
        np.testing.assert_array_equal(
            kdec.paged_gather(torch.from_numpy(pool), torch.from_numpy(tab),
                              layout).numpy(),
            np.asarray(jgather(jnp.asarray(pool), jnp.asarray(tab), layout)))
    want = jdecode(_jbf(q), jgather(_jbf(kp), jnp.asarray(tab), layout),
                   jgather(_jbf(vp), jnp.asarray(tab), layout),
                   jnp.asarray(clen), exp_impl="vexp", layout=layout)
    args = (_bf(q), _bf(kp), _bf(vp), torch.from_numpy(tab),
            torch.from_numpy(clen))
    pol = ExecPolicy(exp_backend="vexp", kernel_backend="reference")
    ref = dispatch("decode_attention_paged", pol)(*args, layout=layout,
                                                  policy=pol)
    np.testing.assert_allclose(_np(ref), _np(want), **TOL)
    plain = kdec.decode_attention_paged_plain(*args, layout=layout)
    np.testing.assert_allclose(_np(plain), _np(want), **TOL)


# ------------------------------------------------------- model vs JAX

B, STEPS, PAGE = 3, 3, 8
PLEN = np.array([24, 9, 17], np.int32)


@pytest.fixture(scope="module")
def models():
    from repro.configs import get_config as jax_config
    from repro.models import api as japi
    from repro_torch.bridge import params_from_numpy
    jcfg = jax_config("gpt2-small").reduced()
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("gpt2-small").reduced()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def _jax_policy(jcfg, exp):
    from repro.runtime import resolve_policy as jax_policy
    return jax_policy(jcfg, env={}, exp_backend=exp,
                      kernel_backend="reference")


def _logits_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGIT_TOL


_JAX = {}


def _jax_paged_decode(models, exp):
    """Ragged prompts prefilled by the JAX package, their KV laid into a
    shuffled page pool, then STEPS teacher-forced JAX paged decode steps
    (computed once per exp backend): (inputs, logits per step, pools)."""
    key = ("decode", exp)
    if key not in _JAX:
        from repro.models import api as japi
        jcfg, jp, _, _ = models
        rng = np.random.default_rng(4)
        toks = rng.integers(0, 512, (B, 24)).astype(np.int32)
        forced = rng.integers(0, 512, (STEPS, B, 1)).astype(np.int32)
        jpol = _jax_policy(jcfg, exp)
        _, cache = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                           "prompt_len": jnp.asarray(PLEN)},
                                policy=jpol)
        ns = -(-(24 + STEPS) // PAGE)
        tab = (1 + rng.permutation(B * ns)).reshape(B, ns).astype(np.int32)
        pools = {}
        for name in ("k", "v"):
            c = np.asarray(cache[name], np.float32)   # (L, B, 24, Hkv, hd)
            c = np.pad(c, ((0, 0), (0, 0), (0, ns * PAGE - 24), (0, 0),
                           (0, 0)))
            pool = np.zeros((c.shape[0], 1 + B * ns, PAGE) + c.shape[3:],
                            np.float32)
            for b in range(B):
                for si in range(ns):
                    pool[:, tab[b, si]] = c[:, b, si * PAGE:(si + 1) * PAGE]
            pools[name] = pool
        jc = {k: jnp.asarray(v, jnp.bfloat16) for k, v in pools.items()}
        step = jax.jit(lambda p, t, c, tb, ps: japi.decode_step_paged(
            p, jcfg, t, c, tb, ps, policy=jpol))
        logits, pos = [], PLEN.copy()
        for t in range(STEPS):
            lg, jc = step(jp, jnp.asarray(forced[t]), jc, jnp.asarray(tab),
                          jnp.asarray(pos))
            logits.append(np.asarray(lg))
            pos = pos + 1
        _JAX[key] = ((forced, tab, pools), logits,
                     {k: np.asarray(v, np.float32) for k, v in jc.items()})
    return _JAX[key]


@pytest.mark.parametrize("tier", ["reference", "cuda"])
@pytest.mark.parametrize("exp", EXPS)
def test_decode_step_paged_matches_jax(models, exp, tier):
    """STEPS teacher-forced paged decode steps through the port over the
    same page pool and table as the JAX package's: logits, and the rows
    the steps wrote into the pool."""
    _, _, cfg, tp = models
    (forced, tab, pools), want, jc = _jax_paged_decode(models, exp)
    tc = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in pools.items()}
    pol = resolve_policy(cfg, env={}, exp_backend=exp, kernel_backend=tier)
    pos = PLEN.copy()
    for t in range(STEPS):
        got, tc = api.decode_step_paged(tp, cfg, forced[t], tc, tab, pos,
                                        policy=pol, device="cpu")
        _logits_close(got.numpy(), want[t])
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].float().numpy(), jc[name],
                                   atol=0.05)


def _jax_hist_prefill(models, exp, h):
    key = ("hist", exp)
    if key not in _JAX:
        from repro.models import api as japi
        jcfg, jp, _, _ = models
        rng = np.random.default_rng(5)
        toks = rng.integers(0, 512, (B, 24)).astype(np.int32)
        jpol = _jax_policy(jcfg, exp)
        _, cache = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                policy=jpol)
        hist = {k: np.asarray(v[:, :, :h], np.float32)
                for k, v in cache.items()}
        suf, slen = toks[:, h:], PLEN - h
        want, wcache = japi.prefill(
            jp, jcfg, {"tokens": jnp.asarray(suf),
                       "prompt_len": jnp.asarray(slen),
                       "hist": {k: jnp.asarray(v, jnp.bfloat16)
                                for k, v in hist.items()}}, policy=jpol)
        _JAX[key] = ((hist, suf, slen), np.asarray(want),
                     {k: np.asarray(v, np.float32) for k, v in
                      wcache.items()})
    return _JAX[key]


@pytest.mark.parametrize("tier", ["reference", "cuda"])
@pytest.mark.parametrize("exp", EXPS)
def test_prefill_with_history_matches_jax(models, exp, tier):
    """Suffix prefill against an 8-token history (attention with
    q_offset=8 and kv_len = 8 + suffix length): logits and suffix KV
    against the JAX package's ``prefill(hist=)``."""
    _, _, cfg, tp = models
    (hist, suf, slen), want, wcache = _jax_hist_prefill(models, exp, 8)
    pol = resolve_policy(cfg, env={}, exp_backend=exp, kernel_backend=tier)
    got, gcache = api.prefill(
        tp, cfg, {"tokens": suf, "prompt_len": slen,
                  "hist": {k: torch.from_numpy(v).to(torch.bfloat16)
                           for k, v in hist.items()}},
        policy=pol, device="cpu")
    _logits_close(got.numpy(), want)
    for name in ("k", "v"):
        np.testing.assert_allclose(gcache[name].float().numpy(),
                                   wcache[name], atol=0.05)


# ------------------------------------------------------- serving identities

@pytest.fixture(scope="module")
def cfg():
    return get_config("gpt2-small").reduced()


@pytest.fixture(scope="module")
def params(cfg):
    return api.init_params(cfg, 0, device="cpu")


def _prompts(cfg, lens, seed=0, prefix=None):
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        p = rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
        if prefix is not None:
            p[:len(prefix)] = prefix
        out.append(p)
    return out


def _serve(cfg, params, prompts, *, paged, max_new=5, max_batch=2,
           max_seq=64, policy=None, **kw):
    srv = Server(cfg, params, max_batch=max_batch, max_seq=max_seq,
                 policy=policy, paged=paged, device="cpu", **kw)
    reqs = [Request(i, p.copy(), max_new) for i, p in enumerate(prompts)]
    srv.run(reqs)
    return {r.rid: r.out for r in reqs}, srv


def _policy(cfg, exp, page):
    """Pages of ``page`` tokens; the contiguous decode then updates on the
    paged sweep's partition (``block_s`` = the page), so the two agree bit
    for bit under vexp."""
    return resolve_policy(cfg, env={}, exp_backend=exp, block_s=page,
                          block_page=page)


@pytest.mark.parametrize("exp", EXPS)
def test_paged_matches_contiguous(cfg, params, exp):
    """Slot churn over a 2-slot pool, ragged lengths: paged serving emits
    the contiguous server's tokens, and the drained pool holds only the
    prefix cache's own pages."""
    pol = _policy(cfg, exp, 8)
    prompts = _prompts(cfg, (5, 11, 7, 20))
    ref, _ = _serve(cfg, params, prompts, paged=False, policy=pol)
    got, srv = _serve(cfg, params, prompts, paged=True, policy=pol)
    assert got == ref
    pool = srv.stats()["default"]["pool"]
    assert pool["pages_used"] == pool["prefix"]["pages"]
    srv.assert_idle_clean()


def test_paged_matches_contiguous_bhsd(cfg, params):
    c = dataclasses.replace(cfg, kv_cache_layout="bhsd")
    pol = _policy(c, "vexp", 8)
    prompts = _prompts(c, (5, 11, 7))
    ref, _ = _serve(c, params, prompts, paged=False, policy=pol)
    got, srv = _serve(c, params, prompts, paged=True, policy=pol)
    assert got == ref
    assert srv._groups["default"].state.data["k"].shape[2:] == (4, 8, 32)


@pytest.mark.parametrize("exp", EXPS)
def test_hot_prefix_matches_cold_solo(cfg, params, exp):
    """A request admitted onto a hot shared prefix (its first pages attach
    to cached pages; only the suffix is prefilled, against the gathered
    history) emits the tokens it gets served cold and alone."""
    pol = resolve_policy(cfg, env={}, exp_backend=exp, block_page=4)
    prefix = np.random.default_rng(5).integers(0, cfg.vocab, (16,),
                                               dtype=np.int32)
    a, b = _prompts(cfg, (24, 30), seed=6, prefix=prefix)
    cold, _ = _serve(cfg, params, [b], paged=True, policy=pol)
    srv = Server(cfg, params, max_batch=1, max_seq=64, policy=pol,
                 paged=True, device="cpu")
    ra, rb = Request(0, a.copy(), 5), Request(1, b.copy(), 5)
    srv.run([ra, rb])                  # a seeds the cache, b rides it hot
    st = srv.stats()["default"]
    assert st["pool"]["prefix"]["hits"] >= 4
    assert (ra.prefix_hit, rb.prefix_hit) == (0, 16)
    assert st["admit_waves"] == 2 and st["hot_waves"] == 1
    assert rb.out == cold[0]
    srv.assert_idle_clean()


def test_hot_admission_in_the_middle_of_decode(cfg, params):
    """A slot freed mid-decode readmits a queued request whose prefix is
    hot: tokens equal the contiguous server's (which shares nothing)."""
    pol = _policy(cfg, "vexp", 4)
    prefix = np.random.default_rng(9).integers(0, cfg.vocab, (12,),
                                               dtype=np.int32)
    prompts = _prompts(cfg, (20, 14, 26, 18, 22), seed=7, prefix=prefix)
    ref, _ = _serve(cfg, params, prompts, paged=False, max_new=4,
                    policy=pol)
    got, srv = _serve(cfg, params, prompts, paged=True, max_new=4,
                      policy=pol)
    assert got == ref
    assert srv.stats()["default"]["pool"]["prefix"]["hits"] > 0
    assert srv._groups["default"].decode_steps > 0
    srv.assert_idle_clean()


def test_eviction_under_pressure_keeps_identity(cfg, params):
    """A pool too small to keep every published chain evicts between
    waves; admission waits for pages and tokens never change."""
    pol = _policy(cfg, "vexp", 4)
    prompts = _prompts(cfg, (30, 28, 26, 31, 29), seed=8)
    ref, _ = _serve(cfg, params, prompts, paged=False, max_new=4,
                    policy=pol)
    got, srv = _serve(cfg, params, prompts, paged=True, max_new=4,
                      policy=pol, block_budget=2 * 16 + 2)
    assert got == ref
    pool = srv.stats()["default"]["pool"]
    assert pool["prefix"]["evictions"] > 0
    assert pool["peak_pages"] <= pool["pages_allocatable"]
    srv.assert_idle_clean()


def test_out_of_blocks_requeues_the_wave_without_leaking(cfg, params,
                                                         monkeypatch):
    """An OutOfBlocks escaping admission while work is in flight puts the
    wave back at the head of the queue (FIFO kept) and it admits later;
    no page leaks. With nothing in flight the bounded retry policy backs
    off, then sheds the head request (finish_reason "failed") and the
    drain returns."""
    pol = _policy(cfg, "vexp", 8)
    prompts = _prompts(cfg, (10, 20), seed=23)       # distinct buckets
    ref, _ = _serve(cfg, params, prompts, paged=False, max_new=6,
                    policy=pol)
    srv = Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                 paged=True, device="cpu")
    state = srv._groups["default"].state
    orig, calls = state.prefill_into, {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:            # the second wave's first attempt
            # the real allocation runs first, then fails: prefill_into
            # must release what it took
            state.alloc.injector = _Injector(0, {"alloc.out_of_blocks": 1})
            try:
                return orig(*a, **kw)
            finally:
                state.alloc.injector = None
        return orig(*a, **kw)

    monkeypatch.setattr(state, "prefill_into", flaky)
    reqs = [Request(i, p.copy(), 6) for i, p in enumerate(prompts)]
    srv.run(reqs)
    assert calls["n"] == 3
    assert {r.rid: r.out for r in reqs} == ref
    assert srv.admit_log == [0, 1]
    srv.assert_idle_clean()

    # 8 pages per reservation + scratch > 8: nothing can ever admit
    tiny = Server(cfg, params, max_batch=2, max_seq=64, policy=pol,
                  paged=True, block_budget=8, device="cpu")
    shed = Request(7, prompts[0].copy(), 2)
    tiny.run([shed])
    assert shed.finish_reason == "failed" and shed.out == []
    assert tiny.stats()["default"]["shed"] == 1
    tiny.assert_idle_clean()


def test_prefix_cache_off_still_serves(cfg, params):
    pol = _policy(cfg, "vexp", 4)
    prompts = _prompts(cfg, (24, 24), seed=11)
    ref, _ = _serve(cfg, params, prompts, paged=False, policy=pol)
    got, srv = _serve(cfg, params, prompts, paged=True, policy=pol,
                      prefix_cache=False)
    assert got == ref
    assert "prefix" not in srv.stats()["default"]["pool"]
    srv.assert_idle_clean()


def test_same_greedy_tokens_as_the_jax_paged_server(models):
    """Same weights, same shared-prefix requests through the JAX paged
    Server (reference tier) and the port's (cuda tier, plain versions on
    the CPU): equal tokens up to the first step whose JAX top-2 logit gap
    is a near tie (<= 2 * LOGIT_TOL)."""
    from repro.launch.serve import Request as JaxRequest, Server as JaxServer
    from repro.models import api as japi
    jcfg, jp, cfg, tp = models
    prefix = np.random.default_rng(13).integers(0, cfg.vocab, (16,),
                                                dtype=np.int32)
    prompts = _prompts(cfg, (20, 27, 23, 18), seed=14, prefix=prefix)
    jpol = _jax_policy(jcfg, "vexp")
    jsrv = JaxServer(jcfg, jp, max_batch=2, max_seq=64, policy=jpol,
                     paged=True, block_page=8)
    jreqs = [JaxRequest(i, p.copy(), 5) for i, p in enumerate(prompts)]
    jsrv.run(jreqs)
    got, srv = _serve(cfg, tp, prompts, paged=True,
                      policy=resolve_policy(cfg, env={}, exp_backend="vexp",
                                            block_page=8))
    assert srv.stats()["default"]["pool"]["prefix"]["hits"] > 0
    for r in jreqs:
        ours = got[r.rid]
        diff = [i for i, (a, b) in enumerate(zip(ours, r.out)) if a != b]
        if not diff:
            assert ours == r.out
            continue
        i = diff[0]
        seq = np.concatenate([r.prompt, np.asarray(r.out[:i], np.int32)])
        logits, _ = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(seq[None])},
                                 policy=jpol)
        top = np.sort(np.asarray(logits)[0, 0])
        assert top[-1] - top[-2] <= 2 * LOGIT_TOL, (r.rid, i)
