"""Sequence-sharded decode in the port, held to the JAX package and to the
unsharded port.

* The partial and packed kernels' plain versions (contiguous B5 / B6,
  paged B8 / B9) at a nonzero ``seq_offset`` with a row that has no key
  on the shard, against the Pallas partial / packed sweeps in interpret
  mode: the raw f32 statistics, and the merge identity on the empty row.
* The local fold of packed tiles (2 and 4 shards, one process) and both
  collective merges (2 gloo ranks), on f32 caches, against JAX's
  unsharded flash-decode (the Pallas kernel in interpret mode) within
  FOLD_LIMIT, the overflow case (q x 60) included; under vexp_hw against
  the JAX package's own sharded decode (``_check_merged`` says why).
* The sharded reduced gpt2-small ``Server`` (``kv_mode="seq"``,
  contiguous and paged, merge "split" and "packed"): every rank's
  tokens equal, equal to the unsharded port's and to the JAX ``Server``'s
  up to a near tie, 1 or 3 collectives per layer and step, no page
  leaked.
* Per-partition page budgets (``OutOfBlocks`` in one partition), and a
  "bhsd" cache under "seq" raising.

The two ranks are two ``python -c`` processes joined through a
``file://`` store in a temporary directory (no TCP port, so parallel
test workers cannot collide), each with its own timeout, spawned once
for the whole file.
"""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.softmax import stats_fold_packed  # noqa: E402
from repro_torch.core.vexp import get_exp_fn  # noqa: E402
from repro_torch.distributed import resolve_kv_shards  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models.block_pool import OutOfBlocks  # noqa: E402
from repro_torch.models.decode_state import PagedKVDecodeState  # noqa: E402
from repro_torch.runtime import ExecPolicy, resolve_policy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPS = ("exact", "vexp", "vexp_hw")
# plain statistics vs the Pallas sweep: the same f32 math summed in
# another order, a few f32 ulps of values up to ~10
STAT_TOL = dict(rtol=1e-5, atol=1e-5)
FOLD_LIMIT = 2e-3         # tests/test_sharded_decode.py:276-309
LOGIT_TOL = 0.02          # as in test_torch_model.py
SPAWN_TIMEOUT_S = 150     # each rank process
KERNEL_NEG_INF = -1e30

# the attention case: b=3, h=8, hkv=4 (G=2), d=32, S=64 cut into shards
# of 32 (seq_offset 32 for shard 1); row 0 (20 keys) has none on shard 1.
# The paged pool's page is the contiguous sweep's block, so both update
# on the same partition and their merges meet the same JAX results.
B, H, HKV, D, S, PAGE, BLOCK = 3, 8, 4, 32, 64, 16, 16
CACHE_LEN = np.array([20, 40, 64], np.int32)


def _attention_inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    ns = S // PAGE
    tab = (1 + rng.permutation(B * ns)).reshape(B, ns).astype(np.int32)
    kp = np.zeros((1 + B * ns, PAGE, HKV, D), np.float32)
    vp = np.zeros_like(kp)
    for b in range(B):
        for si in range(ns):
            kp[tab[b, si]] = k[b, si * PAGE:(si + 1) * PAGE]
            vp[tab[b, si]] = v[b, si * PAGE:(si + 1) * PAGE]
    return q, k, v, tab, kp, vp


def _bf(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)


def _jbf(x):
    return jnp.asarray(x, jnp.bfloat16)


_JAX_UNSHARDED = {}


def _jax_unsharded(q, k, v, exp):
    """JAX's unsharded flash-decode (the Pallas kernel in interpret mode,
    online update per BLOCK keys) on the whole f32 cache; f32 in and out,
    so the comparison sees the merge and not two bf16 roundings."""
    key = (exp, float(np.abs(q).max()))
    if key not in _JAX_UNSHARDED:
        from repro.kernels.decode_attention.ops import decode_attention
        from repro.runtime import ExecPolicy as JaxPolicy
        pol = JaxPolicy(exp_backend=exp, kernel_backend="pallas",
                        interpret=True, block_s=BLOCK)
        _JAX_UNSHARDED[key] = np.asarray(decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(CACHE_LEN), layout="bshd", policy=pol,
            interpret=True), np.float32)
    return _JAX_UNSHARDED[key]


_JAX_SHARDED = {}


def _jax_sharded(q, k, v, exp, n):
    """The JAX package's own sequence-sharded decode of the f32 cache cut
    into n slices: its Pallas packed partial sweep per slice (interpret
    mode), folded by its ``stats_merge_collective_packed`` over a vmapped
    axis standing in for the mesh axis."""
    if (exp, n) not in _JAX_SHARDED:
        from repro.core.softmax import stats_merge_collective_packed
        from repro.core.vexp import get_exp_fn as jax_exp_fn
        from repro.kernels.decode_attention.ops import \
            decode_attention_partial_packed
        from repro.runtime import ExecPolicy as JaxPolicy
        pol = JaxPolicy(exp_backend=exp, kernel_backend="pallas",
                        interpret=True, block_s=BLOCK)
        local = S // n
        tiles = jnp.stack([decode_attention_partial_packed(
            jnp.asarray(q), jnp.asarray(k[:, r * local:(r + 1) * local]),
            jnp.asarray(v[:, r * local:(r + 1) * local]),
            jnp.asarray(CACHE_LEN), r * local, layout="bshd", policy=pol,
            interpret=True) for r in range(n)])
        stats, acc = jax.vmap(
            lambda t: stats_merge_collective_packed(
                t, "shards", exp_fn=jax_exp_fn(exp)),
            axis_name="shards")(tiles)
        out = acc[0, ..., :D] / jnp.maximum(stats.l[0], 1e-30)
        _JAX_SHARDED[exp, n] = np.asarray(out, np.float32).reshape(
            B, 1, H, D)
    return _JAX_SHARDED[exp, n]


def _check_merged(out, q, k, v, exp, n, scale):
    """A merged sharded output against JAX: within FOLD_LIMIT of the
    unsharded flash-decode; under vexp_hw at scale 1 within f32
    tolerance of the JAX package's own sharded decode instead. (The
    merge is exact algebra for an exact exp; for an approximate one
    exp(a) exp(b) != exp(a + b), so one rescale per shard differs from
    the sweep's chained rescales by up to the approximation's error: the
    JAX package's own sharded decode is 2.4e-3 off its unsharded one on
    these inputs under vexp_hw, and the port's matches it.)"""
    assert np.isfinite(out).all()
    if exp == "vexp_hw" and scale == 1.0:
        np.testing.assert_allclose(out, _jax_sharded(q, k, v, exp, n),
                                   **STAT_TOL)
    else:
        assert np.abs(out - _jax_unsharded(q * scale, k, v, exp)).max() \
            <= FOLD_LIMIT


# ---------------------------------------------- plain versions vs Pallas

def _port_stats(kind, mode, exp, q, k, v, tab, kp, vp, off):
    pol = ExecPolicy(exp_backend=exp, block_s=BLOCK)
    cl = torch.from_numpy(CACHE_LEN)
    if kind == "contig":
        args = (_bf(q), _bf(k[:, off:off + S // 2]),
                _bf(v[:, off:off + S // 2]), cl, off)
        f = (kdec.decode_attention_partial if mode == "partial"
             else kdec.decode_attention_partial_packed)
    else:
        half = S // PAGE // 2
        tl = tab[:, (off // PAGE):(off // PAGE) + half]
        args = (_bf(q), _bf(kp), _bf(vp), torch.from_numpy(tl), cl, off)
        f = (kdec.decode_attention_paged_partial if mode == "partial"
             else kdec.decode_attention_paged_packed)
    out = f(*args, layout="bshd", policy=pol)
    if mode == "packed":
        out = (out[..., D:D + 1], out[..., D + 1:], out[..., :D])
    return [t.numpy() for t in out]


def _pallas_stats(kind, mode, exp, q, k, v, tab, kp, vp, off):
    from repro.kernels.decode_attention import kernel as jk
    from repro.kernels.decode_attention import ops as jops
    from repro.runtime import ExecPolicy as JaxPolicy
    cl = jnp.asarray(CACHE_LEN)
    if kind == "contig":
        pol = JaxPolicy(exp_backend=exp, kernel_backend="pallas",
                        interpret=True, block_s=BLOCK)
        args = (_jbf(q), _jbf(k[:, off:off + S // 2]),
                _jbf(v[:, off:off + S // 2]), cl, off)
        if mode == "partial":
            out = jops.decode_attention_partial(*args, layout="bshd",
                                                policy=pol, interpret=True)
        else:
            tile = jops.decode_attention_partial_packed(
                *args, layout="bshd", policy=pol, interpret=True)
            dp = tile.shape[-1] - 2            # the lane-padded head dim
            out = (tile[..., dp:dp + 1], tile[..., dp + 1:],
                   tile[..., :D])
    else:
        half = S // PAGE // 2
        tl = jnp.asarray(tab[:, (off // PAGE):(off // PAGE) + half])
        qg = _jbf(q).reshape(B, HKV, H // HKV, D)
        kw = dict(sm_scale=1.0 / np.sqrt(D), interpret=True, exp_impl=exp,
                  layout="bshd")
        args = (qg, _jbf(kp), _jbf(vp), tl, cl,
                jnp.array([off], jnp.int32))
        if mode == "partial":
            out = jk.decode_attention_kernel_paged_partial(*args, **kw)
        else:
            tile = jk.decode_attention_kernel_paged_packed(*args, **kw)
            out = (tile[..., D:D + 1], tile[..., D + 1:], tile[..., :D])
    return [np.asarray(t, np.float32) for t in out]


@pytest.mark.parametrize("mode", ["partial", "packed"])
@pytest.mark.parametrize("kind", ["contig", "paged"])
@pytest.mark.parametrize("exp", EXPS)
def test_plain_statistics_match_pallas_interpret(kind, mode, exp):
    """Shard 1 of 2 (seq_offset 32): the plain version's (m, l, acc)
    against the Pallas partial / packed sweep in interpret mode; row 0
    has no key on this shard and must hold the identity (-1e30, 0, 0)
    in both packages."""
    inputs = _attention_inputs()
    got = _port_stats(kind, mode, exp, *inputs, off=S // 2)
    want = _pallas_stats(kind, mode, exp, *inputs, off=S // 2)
    for name, g, w in zip(("m", "l", "acc"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **STAT_TOL)
    m, l, acc = got
    assert (m[0] == np.float32(KERNEL_NEG_INF)).all()
    assert (l[0] == 0).all() and (acc[0] == 0).all()
    assert (l[1:] > 0).all()


# ----------------------------------------------------- the local fold

def _fold(tiles, exp):
    st, acc = stats_fold_packed(torch.stack(tiles), exp_fn=get_exp_fn(exp))
    return (acc / torch.clamp(st.l, min=1e-30)).reshape(B, 1, H, D)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("exp", EXPS)
def test_local_fold_matches_jax(exp, n):
    """The packed tiles of n contiguous shards (f32 caches, plain
    versions), folded in one process, against JAX (``_check_merged``),
    and the overflow case (q x 60, shard maxima hundreds apart) finite
    and within FOLD_LIMIT of the unsharded decode."""
    q, k, v, *_ = _attention_inputs()
    local = S // n
    for scale in (1.0, 60.0):
        pol = ExecPolicy(exp_backend=exp, block_s=BLOCK)
        tiles = [kdec.decode_attention_partial_packed(
            torch.from_numpy(q * scale),
            torch.from_numpy(k[:, r * local:(r + 1) * local].copy()),
            torch.from_numpy(v[:, r * local:(r + 1) * local].copy()),
            torch.from_numpy(CACHE_LEN), r * local, layout="bshd",
            policy=pol) for r in range(n)]
        _check_merged(_fold(tiles, exp).numpy(), q, k, v, exp, n, scale)


def test_fold_ignores_empty_shards():
    """A shard tile at the identity contributes nothing: folding it in
    leaves the result bit for bit unchanged."""
    rng = np.random.default_rng(2)
    tile = torch.from_numpy(rng.standard_normal((2, 3, 1, D + 2)).astype(
        np.float32))
    tile[..., D + 1] = tile[..., D + 1].abs() + 0.5          # l > 0
    empty = torch.zeros_like(tile)
    empty[..., D] = KERNEL_NEG_INF
    for exp in EXPS:
        fn = get_exp_fn(exp)
        one = stats_fold_packed(tile[None], exp_fn=fn)
        two = stats_fold_packed(torch.stack([empty, tile, empty]), exp_fn=fn)
        assert torch.equal(one[0].l, two[0].l)
        assert torch.equal(one[1], two[1])


# ---------------------------------------------- placement and budgets

def test_resolve_kv_shards():
    cfg = get_config("gpt2-small").reduced()
    two = SimpleNamespace(rank=0, world=2)
    assert resolve_kv_shards(cfg, "seq", two, 64) == 2
    assert resolve_kv_shards(cfg, "seq", two, 64, page=8) == 2
    assert resolve_kv_shards(cfg, "seq", two, 63) == 1     # S % n
    assert resolve_kv_shards(cfg, "seq", two, 48, page=16) == 1   # 3 pages
    assert resolve_kv_shards(cfg, "seq", None, 64) == 1    # one rank
    assert resolve_kv_shards(cfg, "auto", two, 64) == 1
    assert resolve_kv_shards(cfg, "batch", two, 64) == 1
    with pytest.raises(ValueError):
        resolve_kv_shards(cfg, "rows", two, 64)


def test_seq_with_a_bhsd_cache_raises():
    import dataclasses
    cfg = dataclasses.replace(get_config("gpt2-small").reduced(),
                              kv_cache_layout="bhsd")
    from repro_torch.models import api
    params = api.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="head sharding"):
        Server(cfg, params, max_seq=64, device="cpu", kv_mode="seq")
    Server(cfg, params, max_seq=64, device="cpu", kv_mode="auto")


def test_seq_on_one_rank_serves_unsharded(capsys):
    from repro_torch.launch.serve import main
    main(["--reduced", "--device", "cpu", "--requests", "2", "--max-new",
          "2", "--kv-mode", "seq"])
    out = capsys.readouterr().out
    assert "decode axis default: unsharded" in out
    assert "served 2 requests on cpu" in out


def test_partitioned_budgets_and_per_partition_out_of_blocks():
    """A 2-shard paged state (rank 0's view; admission needs no
    collective on a cold wave) gives each table column to its rank's
    partition: needs and budgets are per partition, the device table
    holds rank 0's columns as local ids, and a wave that exhausts one
    partition raises OutOfBlocks with every page released."""
    from repro_torch.models import api
    cfg = get_config("gpt2-small").reduced()
    params = api.init_params(cfg, 0, device="cpu")
    pol = resolve_policy(cfg, env={}, block_page=8)
    comm = SimpleNamespace(rank=0, world=2)
    st = PagedKVDecodeState(cfg, params, pol, 2, 64, device="cpu",
                            comm=comm)
    assert st.ns == 8 and st.tables.shape == (2, 4)
    assert st.alloc.n_partitions == 2 and st.n_pages == 2 + 2 * 8
    assert st.free_with_evictable().tolist() == [8, 8]
    prompt = np.arange(12, dtype=np.int32)
    need, h = st.admission_need(prompt)
    assert need.tolist() == [4, 4] and h == 0
    toks = np.zeros((2, 16), np.int32)
    toks[0, :12] = prompt
    st.prefill_into([0], toks, np.array([12, 1]))
    pages = st.slot_pages[0]
    assert [st.alloc.part_of(g) for g in pages] == [0] * 4 + [1] * 4
    assert st.tables[0].tolist() == [st.alloc.local_id(g)
                                     for g in pages[:4]]
    assert st.free_with_evictable().tolist() == [4, 4]
    # partition 1 loses its free pages: the next wave cannot reserve there
    taken = st.alloc.alloc_cols([4, 5, 6, 7])
    free0 = st.alloc.free_counts().tolist()
    toks[1, :12] = prompt + 1
    with pytest.raises(OutOfBlocks):
        st.prefill_into([1], toks, np.array([12, 12]))
    assert st.alloc.free_counts().tolist() == free0
    for gid in taken:
        st.alloc.decref(gid)
    st.reset_slots([0])
    st.pcache.drop_all()
    assert st.alloc.n_used() == 0
    st.check_integrity(())


# ------------------------------------------------ the spawned ranks

_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(2)
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.distributed import ShardSpec, init_shard_group
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels.dispatch import dispatch
    from repro_torch.launch.serve import Request, Server
    from repro_torch.runtime import ExecPolicy, resolve_policy
    comm = init_shard_group(f"file://{tmp}/store", rank, world,
                            device="cpu", timeout_s=60)
    inp = np.load(f"{tmp}/inputs.npz")
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    bf = lambda x: f32(x).to(torch.bfloat16)
    q, k, v, cl = inp["q"], inp["k"], inp["v"], torch.from_numpy(inp["cl"])
    kp, vp, tab = inp["kp"], inp["vp"], inp["tab"]
    s, page = k.shape[1], int(inp["page"])
    local, cols = s // world, tab.shape[1] // world
    out = {}
    for strat in ("packed", "split"):
        for exp in ("exact", "vexp", "vexp_hw"):
            pol = ExecPolicy(exp_backend=exp, merge_strategy=strat,
                             block_s=int(inp["block"]))
            for tag, qq in (("", q), ("q60_", q * 60.0)):
                o = kdec.decode_attention_partial_merged(
                    f32(qq), f32(k[:, rank * local:(rank + 1) * local]),
                    f32(v[:, rank * local:(rank + 1) * local]), cl,
                    rank * local, comm=comm, layout="bshd", policy=pol)
                out[f"{tag}{strat}_{exp}"] = o.float().tolist()
            o = kdec.decode_attention_paged_partial_merged(
                f32(q), f32(kp), f32(vp),
                torch.from_numpy(tab[:, rank * cols:(rank + 1) * cols]), cl,
                rank * cols * page, comm=comm, layout="bshd", policy=pol)
            out[f"paged_{strat}_{exp}"] = o.float().tolist()
    ref = ExecPolicy(exp_backend="vexp", kernel_backend="reference")
    o = dispatch("decode_attention_sharded", ref)(
        bf(q), bf(k[:, rank * local:(rank + 1) * local]),
        bf(v[:, rank * local:(rank + 1) * local]), cl,
        shard=ShardSpec(comm, local), layout="bshd", policy=ref)
    out["reference_tier_vexp"] = o.float().tolist()

    # the reduced gpt2-small server on the JAX package's weights
    cfg = get_config("gpt2-small").reduced()
    w = np.load(f"{tmp}/params.npz")
    tree = {}
    for key in w.files:
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = w[key]
    params = params_from_numpy(tree, cfg, device="cpu")
    spec = json.load(open(f"{tmp}/serve.json"))
    base = resolve_policy(cfg, env={}, block_page=spec["page"])
    groups = {n: base.replace(exp_backend=e, merge_strategy=m)
              for n, (e, m) in spec["groups"].items()}
    for path, paged in (("contig", False), ("paged", True)):
        srv = Server(cfg, params, max_batch=2, max_seq=spec["max_seq"],
                     policy=base, policy_groups=groups, device="cpu",
                     paged=paged, kv_mode="seq", shards=comm)
        reqs = [Request(i, np.asarray(p, np.int32), spec["max_new"],
                        group=g)
                for i, (p, g) in enumerate(zip(spec["prompts"],
                                               spec["req_groups"]))]
        srv.run(reqs)
        stats = srv.stats()
        srv.assert_idle_clean()
        out[path] = {"tokens": [r.out for r in reqs],
                     "hits": [r.prefix_hit for r in reqs],
                     "stats": {n: {k2: stats[n][k2] for k2 in (
                         "shards", "merge_strategy", "collectives",
                         "decode_steps")} for n in stats}}
    json.dump(out, open(f"{tmp}/rank{rank}.json", "w"))
    torch.distributed.destroy_process_group()
""")

SERVE = {"page": 8, "max_seq": 64, "max_new": 4,
         "groups": {"eval": ("exact", "split"), "bulk": ("vexp", "packed")}}


def _serve_prompts(cfg):
    """6 requests on a shared 40-token prefix (5 pages: the history of a
    hot wave spans both ranks' columns) plus 4-20 own tokens."""
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, cfg.vocab, (40,), dtype=np.int32)
    lens = (44, 52, 47, 60, 45, 50)
    out = []
    for n in lens:
        p = rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
        p[:40] = prefix
        out.append(p)
    return out


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


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    """Both ranks' results (spawned once): the merges on the attention
    case, and the sharded servers on the JAX weights."""
    jcfg, jp, cfg, _ = models
    tmp = tmp_path_factory.mktemp("sharded")
    q, k, v, tab, kp, vp = _attention_inputs()
    np.savez(tmp / "inputs.npz", q=q, k=k, v=v, cl=CACHE_LEN, tab=tab,
             kp=kp, vp=vp, page=PAGE, block=BLOCK)
    flat = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}/")
            else:
                flat[prefix + key] = np.asarray(val, np.float32)
    walk(jax.tree.map(np.asarray, jp), "")
    np.savez(tmp / "params.npz", **flat)
    prompts = _serve_prompts(cfg)
    names = sorted(SERVE["groups"])
    spec = dict(SERVE, prompts=[p.tolist() for p in prompts],
                req_groups=[names[i % 2] for i in range(len(prompts))])
    (tmp / "serve.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), "2",
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    got = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    return got, (q, k, v, tab, kp, vp), spec, prompts


def test_ranks_agree(ranks):
    """Every output of the two ranks is the same, bit for bit."""
    got, *_ = ranks
    assert got[0] == got[1]


@pytest.mark.parametrize("strategy", ["packed", "split"])
@pytest.mark.parametrize("exp", EXPS)
def test_collective_merge_matches_jax(ranks, strategy, exp):
    """2 gloo ranks, each sweeping its half of the f32 cache: the merged
    output, contiguous and paged, against JAX (``_check_merged``), and
    the overflow case (q x 60) finite and within FOLD_LIMIT."""
    got, (q, k, v, *_), _, _ = ranks
    out = got[0]
    for key in (f"{strategy}_{exp}", f"paged_{strategy}_{exp}"):
        _check_merged(np.asarray(out[key], np.float32), q, k, v, exp, 2,
                      1.0)
    _check_merged(np.asarray(out[f"q60_{strategy}_{exp}"], np.float32),
                  q, k, v, exp, 2, 60.0)


def test_reference_tier_gathers_and_matches_jax(ranks):
    """The reference tier of decode_attention_sharded (all_gather of the
    slices, then the one-pass decode) against JAX's decode reference on
    the whole bf16 cache: attention tolerance (2^-7)."""
    from repro.core.attention import decode_attention as jdecode
    got, (q, k, v, *_), _, _ = ranks
    want = np.asarray(jdecode(_jbf(q), _jbf(k), _jbf(v),
                              jnp.asarray(CACHE_LEN), exp_impl="vexp",
                              layout="bshd"), np.float32)
    np.testing.assert_allclose(np.asarray(got[0]["reference_tier_vexp"]),
                               want, atol=2.0 ** -7, rtol=2.0 ** -7)


@pytest.mark.parametrize("path", ["contig", "paged"])
def test_sharded_server_counts_collectives(ranks, models, path):
    """Each group decodes 2-way sharded with its merge strategy: 3
    collectives per layer and step when split, 1 when packed; hot
    admission happened on the paged pool."""
    got, _, spec, _ = ranks
    _, _, cfg, _ = models
    st = got[0][path]["stats"]
    for name, (_, strategy) in spec["groups"].items():
        g = st[name]
        assert g["shards"] == 2 and g["merge_strategy"] == strategy
        per = cfg.n_layers * (3 if strategy == "split" else 1)
        assert g["decode_steps"] > 0
        assert g["collectives"] == per * g["decode_steps"]
    if path == "paged":
        assert any(got[0][path]["hits"])


def _first_divergence(a, b):
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    return diff[0] if diff else None


@pytest.mark.parametrize("path", ["contig", "paged"])
def test_sharded_server_matches_unsharded_port(ranks, models, path):
    """The same requests through the unsharded port server: equal tokens
    up to the first step whose top-2 logit gap (the port's reference
    tier) is a near tie."""
    from repro_torch.models import transformer
    got, _, spec, prompts = ranks
    _, _, cfg, tp = models
    base = resolve_policy(cfg, env={}, block_page=spec["page"])
    groups = {n: base.replace(exp_backend=e)
              for n, (e, _) in spec["groups"].items()}
    srv = Server(cfg, tp, max_batch=2, max_seq=spec["max_seq"], policy=base,
                 policy_groups=groups, device="cpu", paged=path == "paged")
    reqs = [Request(i, p.copy(), spec["max_new"], group=g)
            for i, (p, g) in enumerate(zip(prompts, spec["req_groups"]))]
    srv.run(reqs)
    for r, ours in zip(reqs, got[0][path]["tokens"]):
        i = _first_divergence(ours, r.out)
        if i is None:
            continue
        seq = np.concatenate([r.prompt, np.asarray(r.out[:i], np.int32)])
        lg, _ = transformer.prefill(
            tp, cfg, torch.as_tensor(seq[None]),
            policy=groups[r.group].replace(kernel_backend="reference"))
        top = torch.topk(lg[0, 0], 2).values
        assert float(top[0] - top[1]) <= 2 * LOGIT_TOL, (r.rid, i)


@pytest.mark.parametrize("path", ["contig", "paged"])
def test_sharded_server_matches_jax_server(ranks, models, path):
    """The same requests through the JAX ``Server`` (unsharded, reference
    tier): equal tokens up to the first step whose JAX top-2 logit gap is
    a near tie (<= 2 * LOGIT_TOL)."""
    from repro.launch.serve import Request as JaxRequest, Server as JaxServer
    from repro.models import api as japi
    from repro.runtime import resolve_policy as jax_policy
    got, _, spec, prompts = ranks
    jcfg, jp, _, _ = models
    groups = {n: jax_policy(jcfg, env={}, exp_backend=e,
                            kernel_backend="reference")
              for n, (e, _) in spec["groups"].items()}
    kw = dict(paged=True, block_page=spec["page"]) if path == "paged" else {}
    jsrv = JaxServer(jcfg, jp, max_batch=2, max_seq=spec["max_seq"],
                     policy=groups["bulk"], policy_groups=groups, **kw)
    jreqs = [JaxRequest(i, p.copy(), spec["max_new"], group=g)
             for i, (p, g) in enumerate(zip(prompts, spec["req_groups"]))]
    jsrv.run(jreqs)
    for r, ours in zip(jreqs, got[0][path]["tokens"]):
        i = _first_divergence(ours, r.out)
        if i is None:
            continue
        seq = np.concatenate([r.prompt, np.asarray(r.out[:i], np.int32)])
        logits, _ = japi.prefill(jp, jcfg,
                                 {"tokens": jnp.asarray(seq[None])},
                                 policy=groups[r.group])
        top = np.sort(np.asarray(logits)[0, 0])
        assert top[-1] - top[-2] <= 2 * LOGIT_TOL, (r.rid, i)
