"""The port's softmax against the JAX reference.

* ``core.softmax`` (with ``where`` masks and a row masked everywhere),
  ``log_softmax`` and the online stats algebra (``stats_update`` folded
  over blocks, ``stats_merge``) against ``repro.core.softmax``.
* The softmax op's plain version, which the CUDA kernel is held to on the
  card, against the Pallas ``softmax_rows`` run in interpret mode (through
  ``ops.softmax``, which pads lanes with NEG_INF and rows to the block) at
  one small shape whose rows and lanes are both unaligned.
* The dispatch tiers and the policy's new fields.

Inputs are made with numpy from a seed. Tolerance: both sides compute in
f32 with the same exp (vexp / vexp_hw bit for bit, exact within a few
ulp) but sum the row in different orders, which moves 1/sum by an ulp or
two: rtol 1e-5 (about 80 f32 ulps), atol 1e-7 for the tiny tail values.
bf16 outputs: one bf16 ulp (2^-8 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import softmax as jsm  # noqa: E402
from repro.core.vexp import get_exp_fn as jexp  # noqa: E402
from repro.kernels.softmax.ops import softmax as pallas_softmax  # noqa: E402
from repro.runtime import ExecPolicy as JaxPolicy  # noqa: E402
from repro_torch.core import softmax as tsm  # noqa: E402
from repro_torch.core.vexp import get_exp_fn as texp  # noqa: E402
from repro_torch.kernels import softmax as ksm  # noqa: E402
from repro_torch.kernels.dispatch import dispatch  # noqa: E402
from repro_torch.runtime import ExecPolicy, resolve_policy  # noqa: E402

EXPS = ("exact", "vexp", "vexp_hw")
F32 = dict(rtol=1e-5, atol=1e-7)

# jitted: the JAX functions run as one program instead of op by op
j_softmax = jax.jit(jsm.softmax, static_argnames=("axis", "exp_impl"))
j_log_softmax = jax.jit(jsm.log_softmax, static_argnames=("axis",
                                                          "exp_impl"))
j_update = jax.jit(jsm.stats_update, static_argnames=("axis", "exp_fn"))
j_merge = jax.jit(jsm.stats_merge, static_argnames=("exp_fn",))


def _x(shape, seed=0, scale=4.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("exp", EXPS)
def test_core_softmax_matches_jax(exp):
    x = _x((5, 37, 33))
    for axis in (-1, 1):
        want = np.asarray(j_softmax(jnp.asarray(x), axis, exp_impl=exp))
        got = tsm.softmax(torch.from_numpy(x), axis, exp_impl=exp).numpy()
        np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("exp", EXPS)
def test_masked_softmax_and_fully_masked_row(exp):
    """``where`` drops entries from weights and normalizer; a row masked
    everywhere comes out zeros, not NaN, in both packages."""
    x = _x((6, 40), seed=1)
    where = np.random.default_rng(2).random((6, 40)) < 0.6
    where[3] = False
    want = np.asarray(j_softmax(jnp.asarray(x), exp_impl=exp,
                                where=jnp.asarray(where)))
    got = tsm.softmax(torch.from_numpy(x), exp_impl=exp,
                      where=torch.from_numpy(where)).numpy()
    assert np.isfinite(got).all() and (got[3] == 0).all()
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("exp", EXPS)
def test_log_softmax_matches_jax(exp):
    x = _x((7, 50), seed=3)
    want = np.asarray(j_log_softmax(jnp.asarray(x), exp_impl=exp))
    got = tsm.log_softmax(torch.from_numpy(x), exp_impl=exp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("exp", EXPS)
def test_stats_algebra_matches_jax(exp):
    """Fold stats_update over three blocks (one of them -inf-masked for
    one row), then merge two partial folds: (m, l) and the rescale
    factors against the JAX algebra."""
    x = _x((4, 96), seed=4)
    x[1, 32:64] = -np.inf
    blocks = [x[:, i:i + 32] for i in range(0, 96, 32)]

    def fold(update, exp_fn, arr, blks, init):
        st, alphas = init((4,)), []
        for b in blks:
            st, _, al = update(st, arr(b), exp_fn=exp_fn)
            alphas.append(np.asarray(al))
        return st, alphas

    jst, jal = fold(j_update, jexp(exp), jnp.asarray, blocks,
                    jsm.stats_init)
    tst, tal = fold(tsm.stats_update, texp(exp), torch.from_numpy, blocks,
                    tsm.stats_init)
    np.testing.assert_array_equal(tst.m.numpy(), np.asarray(jst.m))
    np.testing.assert_allclose(tst.l.numpy(), np.asarray(jst.l), **F32)
    for a, b in zip(tal, jal):
        np.testing.assert_allclose(a, b, **F32)
    ja, _ = fold(j_update, jexp(exp), jnp.asarray, blocks[:2],
                 jsm.stats_init)
    jb, _ = fold(j_update, jexp(exp), jnp.asarray, blocks[2:],
                 jsm.stats_init)
    ta, _ = fold(tsm.stats_update, texp(exp), torch.from_numpy, blocks[:2],
                 tsm.stats_init)
    tb, _ = fold(tsm.stats_update, texp(exp), torch.from_numpy, blocks[2:],
                 tsm.stats_init)
    jm, jaa, jab = j_merge(ja, jb, exp_fn=jexp(exp))
    tm, taa, tab = tsm.stats_merge(ta, tb, exp_fn=texp(exp))
    np.testing.assert_array_equal(tm.m.numpy(), np.asarray(jm.m))
    for a, b in ((tm.l, jm.l), (taa, jaa), (tab, jab)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    # stats_init's empty partial is the merge identity
    tm2, _, _ = tsm.stats_merge(tsm.stats_init((4,)), tm, exp_fn=texp(exp))
    np.testing.assert_array_equal(tm2.m.numpy(), tm.m.numpy())
    np.testing.assert_array_equal(tm2.l.numpy(), tm.l.numpy())
    assert tsm.KERNEL_NEG_INF == jsm.KERNEL_NEG_INF


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exp", EXPS)
def test_softmax_op_plain_matches_pallas_interpret(exp, dtype):
    """x (3, 200, 67), softmax over the middle axis, so both wrappers also
    move the axis: 201 rows (not a multiple of the 64-row block) of 200
    lanes (padded to 256 with NEG_INF by the reference's wrapper)."""
    x = _x((3, 200, 67), seed=5)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = pallas_softmax(jx, 1, interpret=True,
                          policy=JaxPolicy(exp_backend=exp, interpret=True))
    pol = ExecPolicy(exp_backend=exp)
    got = dispatch("softmax", pol)(tx, 1, policy=pol)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert torch.equal(got, ksm.softmax_plain(tx, 1, exp_backend=exp))
    tol = F32 if dtype == "float32" else dict(rtol=2.0 ** -8, atol=1e-7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_softmax_tiers_and_core_routing():
    """``core.softmax(policy=)`` goes to the kernel's path under the cuda
    tier (its plain version on the CPU) and stays in ``core.softmax``
    under the others; a masked call never takes the kernel."""
    x = torch.from_numpy(_x((9, 130), seed=6))
    for tier in ("cuda", "reference", "eager"):
        pol = ExecPolicy(exp_backend="vexp_hw", kernel_backend=tier)
        got = tsm.softmax(x, policy=pol)
        want = (ksm.softmax_plain(x, exp_backend="vexp_hw") if tier == "cuda"
                else tsm.softmax(x, exp_impl="vexp_hw"))
        assert torch.equal(got, want), tier
    where = torch.ones_like(x, dtype=torch.bool)
    where[0] = False
    got = tsm.softmax(x, where=where, policy=ExecPolicy(exp_backend="vexp"))
    assert (got[0] == 0).all()


def test_policy_block_rows_and_block_page():
    """block_page (64) resolves like the other fields. The softmax kernel
    runs one row per CTA, so the port has no row block: block_rows is
    not a field and REPRO_BLOCK_ROWS is ignored."""
    p = resolve_policy(None, env={})
    assert p.block_page == 64
    env = {"REPRO_BLOCK_ROWS": "32", "REPRO_BLOCK_PAGE": "16"}
    p = resolve_policy(None, env=env)
    assert p.block_page == 16 and not hasattr(p, "block_rows")
    assert "p16" in p.describe()
    with pytest.raises(ValueError, match="block_rows"):
        resolve_policy(None, env={}, block_rows=32)
    assert resolve_policy(None, env=env, block_page=8).block_page == 8
    with pytest.raises(ValueError):
        ExecPolicy(block_page=0)
