"""The port's masked aggregation (fault guard, partial participation)
against the reference.

``Aggregator.tree_masked`` (the gspmd oracle) is held to the reference's
under ``jax.jit``; the masked plain kernel versions (``robust_agg_plain``
with ``valid`` / ``bvalid``, ``pair_gram_plain``, ``rfa_iter_plain``,
``weighted_sum_plain`` with ``valid``) to ``repro.kernels``' kernels run
in interpret mode, dense and from the sparse wire, at n ∈ {5, 8, 33, 64};
the drivers (fused and blocked, m ∈ {65, 130}) and
``sharded_agg.tree_aggregate_pallas`` with ``valid`` to the reference's.
Invalid rows hold NaN / inf, which the select must keep out of every sum.

Tolerances, each of the largest entry: the coordinate rules bit for bit
(equality, which counts -0.0 equal to +0.0: the reference's kernel gathers
a rank by a where-sum, so a -0.0 comes out +0.0, where the gspmd oracle's
``take`` keeps it), a 1-D leaf's buckets included, whose compiled
matrix-vector product the port repeats (``aggregators.xla_gemv``); the
norm kernels as
their unmasked cases (``tests/test_torch_norm_agg.py``): bit for bit for
the weighted sum, 1e-6 through W, 1e-5 for sums over d; 2e-5, the
reference's pallas≡gspmd tolerance, for RFA and Krum aggregates, whose
selected row is identical.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import sharded_agg as jsa
from repro.core import wire as jwire
from repro.core.attacks import CoordAttack as JCoordAttack
from repro.faults import guard as jguard
from repro.kernels import norm_agg as jnorm
from repro.kernels import quantize as jq
from repro.kernels.robust_agg import robust_agg as jax_robust_agg
from repro_torch import random as R
from repro_torch.convert import key_from_numpy, tree_from_numpy
from repro_torch.core import aggregators as tagg
from repro_torch.core import sharded_agg as tsa
from repro_torch.core import wire as twire
from repro_torch.core.attacks import CoordAttack
from repro_torch.faults import guard
from repro_torch.kernels import norm_agg, quantize
from repro_torch.kernels.robust_agg import robust_agg, robust_agg_plain

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

REL = 1e-6             # through W, in another order
SUM_REL = 1e-5         # sums over d, in another order
AGG_TOL = 2e-5         # the reference's pallas≡gspmd tolerance
ALIE_Z = 1.06
RULES = ["mean", "cm", "tm", "rfa", "krum"]


def _close(got, ref, rel):
    """Agreement to ``rel`` of the largest entry; 0 means equal."""
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if rel == 0:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=rel * max(1.0, np.abs(ref).max()))


def _valid(n, seed):
    """About a third of the rows invalid, row 0 always valid."""
    v = np.random.default_rng(seed).random(n) > 0.35
    v[0] = True
    return v


def _poisoned_tree(n, valid, seed):
    rng = np.random.default_rng(seed)
    xs = {"b": rng.standard_normal((n,)).astype(np.float32),
          "w": rng.standard_normal((n, 7, 3)).astype(np.float32)}
    bad = np.where(~valid)[0]
    xs["b"][bad] = np.nan
    xs["w"][bad[:1]] = np.inf
    xs["w"][bad[1:], 2] = np.nan
    return xs


# ---------------------------------------------------------------------------
# the gspmd oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [7, 35])
@pytest.mark.parametrize("s", [0, 2, 3])
@pytest.mark.parametrize("rule", RULES)
def test_tree_masked(rule, s, n):
    valid = _valid(n, n + s)
    xs = _poisoned_tree(n, valid, n * 7 + s)
    key = jax.random.PRNGKey(n + s)
    jagg_ = jagg.get_aggregator(rule, bucket_size=s, n_byz=1)
    ref = jax.jit(lambda k, x, v: jagg_.tree_masked(k, x, v))(
        key, {k: jnp.asarray(v) for k, v in xs.items()}, jnp.asarray(valid))
    got = tagg.get_aggregator(rule, bucket_size=s, n_byz=1).tree_masked(
        key_from_numpy(key), tree_from_numpy(xs), torch.as_tensor(valid))
    for k in ("b", "w"):
        if rule in ("rfa", "krum"):
            tol = AGG_TOL
        else:
            tol = 0
        _close(got[k], ref[k], tol)


def test_tree_masked_with_every_row_valid_is_tree():
    """All rows valid and s | n: the masked twin is the plain rule."""
    xs = {"w": torch.randn(8, 5, generator=torch.Generator().manual_seed(1))}
    every = torch.ones(8, dtype=torch.bool)
    for rule in ("cm", "tm", "krum"):
        agg = tagg.get_aggregator(rule, bucket_size=2, n_byz=1)
        assert torch.equal(agg.tree_masked(R.PRNGKey(3), xs, every)["w"],
                           agg.tree(R.PRNGKey(3), xs)["w"])


# ---------------------------------------------------------------------------
# the masked plain kernels, dense and wire
# ---------------------------------------------------------------------------

def _inputs(n, d, load, seed):
    """(reference input, port input, valid, mask, mean, std) with NaN in
    the invalid rows (the dense stack, or the wire's values)."""
    rng = np.random.default_rng(seed)
    valid = _valid(n, seed)
    mask = np.arange(n) < max(1, n // 5)
    mean = rng.standard_normal(d).astype(np.float32)
    std = np.abs(rng.standard_normal(d)).astype(np.float32)
    if load == "dense":
        x = rng.standard_normal((n, d)).astype(np.float32)
        x[~valid] = np.nan
        return jnp.asarray(x), torch.as_tensor(x), valid, mask, mean, std
    k = max(d // 10, 1)
    idx = np.sort(np.stack([rng.permutation(d)[:k] for _ in range(n)]),
                  axis=1).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    vals[~valid] = np.nan
    base = rng.standard_normal((1, d)).astype(np.float32)
    jsrc = jq.WireSrc(fmt="sparse", n=n, d=d,
                      arrays=(("vals", jnp.asarray(vals)),
                              ("idx", jnp.asarray(idx))),
                      base=jnp.asarray(base))
    tsrc = quantize.WireSrc(fmt="sparse", n=n, d=d,
                            arrays=(("vals", torch.as_tensor(vals)),
                                    ("idx", torch.as_tensor(idx))),
                            base=torch.as_tensor(base))
    return jsrc, tsrc, valid, mask, mean, std


def _bucketing(n, s, valid, seed):
    """(W_jax, W_port, bvalid_jax, bvalid_port) of the masked operator
    (equal bit for bit), or the s <= 1 case: no W, bvalid = valid."""
    if s <= 1:
        return None, None, jnp.asarray(valid), torch.as_tensor(valid)
    perm = np.random.default_rng(seed + 100).permutation(n)
    wj, bj = jguard.masked_bucket_matrix(jnp.asarray(perm), n, s,
                                         jnp.asarray(valid))
    wt, bt = guard.masked_bucket_matrix(torch.as_tensor(perm), n, s,
                                        torch.as_tensor(valid))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    return wj, wt, bj, bt


@pytest.mark.parametrize("load", ["dense", "wire"])
@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("rule", ["mean", "median", "trimmed"])
@pytest.mark.parametrize("n", [5, 8, 33, 64])
def test_masked_robust_agg(n, rule, s, load):
    jx, tx, valid, mask, mean, std = _inputs(n, 300, load, n * 3 + s)
    wj, wt, bj, bt = _bucketing(n, s, valid, n)
    ref = jax_robust_agg(jx, wj, jnp.asarray(mask), jnp.asarray(mean),
                         jnp.asarray(std), jnp.asarray(valid), bj,
                         rule=rule, trim=1, interpret=True,
                         attack_fn=JCoordAttack("ALIE", ALIE_Z))
    got = robust_agg_plain(tx, wt, torch.as_tensor(mask),
                           torch.as_tensor(mean), torch.as_tensor(std),
                           torch.as_tensor(valid), bt, rule=rule, trim=1,
                           attack=CoordAttack("ALIE", ALIE_Z))
    _close(got, ref, 0)


@pytest.mark.parametrize("rule", ["median", "trimmed"])
def test_masked_rule_picks_ranks_of_the_valid_count(rule):
    """Rows 1 and 3 invalid (filled with +inf) out of 6: the median of the
    4 valid values is the mean of their middle two, the trimmed mean drops
    one at each end."""
    x = torch.tensor([[4.0], [9e9], [1.0], [-9e9], [3.0], [2.0]])
    bvalid = torch.tensor([True, False, True, False, True, True])
    got = robust_agg(x, bvalid=bvalid, rule=rule)
    assert float(got[0]) == 2.5


@pytest.mark.parametrize("load", ["dense", "wire"])
@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("n", [5, 33])
def test_masked_norm_kernels(n, s, load):
    jx, tx, valid, mask, mean, std = _inputs(n, 300, load, n * 5 + s)
    wj, wt, _, _ = _bucketing(n, s, valid, n)
    m = n if wt is None else wt.shape[0]
    rng = np.random.default_rng(n)
    wr = rng.random(m).astype(np.float32) + 0.1
    wr /= wr.sum()
    wn = rng.random(n).astype(np.float32)
    jkw = dict(mask=jnp.asarray(mask), good_mean=jnp.asarray(mean),
               good_std=jnp.asarray(std), valid=jnp.asarray(valid),
               attack_fn=JCoordAttack("ALIE", ALIE_Z), interpret=True)
    tkw = dict(mask=torch.as_tensor(mask), good_mean=torch.as_tensor(mean),
               good_std=torch.as_tensor(std), valid=torch.as_tensor(valid),
               attack=CoordAttack("ALIE", ALIE_Z))
    _close(norm_agg.pair_gram_plain(tx, wt, **tkw),
           jnorm.pair_gram(jx, wj, **jkw), SUM_REL)
    jz, jsq = jnorm.rfa_iter(jx, jnp.asarray(wr), wj, **jkw)
    tz, tsq = norm_agg.rfa_iter_plain(tx, torch.as_tensor(wr), wt, **tkw)
    _close(tz, jz, 0 if wt is None else REL)
    _close(tsq, jsq, SUM_REL)
    _close(norm_agg.weighted_sum_plain(tx, torch.as_tensor(wn), **tkw),
           jnorm.weighted_sum(jx, jnp.asarray(wn), **jkw), 0)


@pytest.mark.parametrize("load", ["dense", "wire"])
@pytest.mark.parametrize("driver", ["rfa", "krum"])
@pytest.mark.parametrize("n", [8, 64])
def test_masked_drivers(n, driver, load):
    jx, tx, valid, mask, mean, std = _inputs(n, 300, load, n * 11)
    wj, wt, bj, bt = _bucketing(n, 2, valid, n)
    jkw = dict(w_mat=wj, mask=jnp.asarray(mask), means=[jnp.asarray(mean)],
               stds=[jnp.asarray(std)], valid=jnp.asarray(valid), bvalid=bj,
               attack_fn=JCoordAttack("ALIE", ALIE_Z), interpret=True)
    tkw = dict(w_mat=wt, mask=torch.as_tensor(mask),
               means=[torch.as_tensor(mean)], stds=[torch.as_tensor(std)],
               valid=torch.as_tensor(valid), bvalid=bt,
               attack=CoordAttack("ALIE", ALIE_Z))
    if driver == "rfa":
        ref = jnorm.rfa_segments([jx], iters=8, **jkw)
        got = norm_agg.rfa_segments([tx], iters=8, **tkw)
    else:
        ref = jnorm.krum_segments([jx], n_byz=1, **jkw)
        got = norm_agg.krum_segments([tx], n_byz=1, **tkw)
    _close(got[0], ref[0], AGG_TOL)


@pytest.mark.parametrize("m", [8, 65, 130])
def test_krum_select_with_bvalid(m):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 40)).astype(np.float32)
    g = x @ x.T
    bvalid = _valid(m, m)
    _, jscores, jbest = jnorm.krum_select(jnp.asarray(g), 2,
                                          jnp.asarray(bvalid))
    _, tscores, tbest = norm_agg.krum_select(torch.as_tensor(g), 2,
                                             torch.as_tensor(bvalid))
    assert int(tbest) == int(jbest) and bvalid[int(tbest)]
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                               rtol=SUM_REL)
    assert np.isinf(tscores.numpy()[~bvalid]).all()


@pytest.mark.parametrize("m", [65, 130])
@pytest.mark.parametrize("driver", ["rfa", "krum"])
def test_blocked_drivers_with_bvalid(driver, m):
    rng = np.random.default_rng(m + len(driver))
    segs = [rng.standard_normal((m, d)).astype(np.float32) for d in (1, 300)]
    bvalid = _valid(m, m)
    for x in segs:
        x[3] *= 0.1
        x[~bvalid] = 0.0
    kw = {"iters": 8} if driver == "rfa" else {"n_byz": m // 10}
    ref = getattr(jnorm, f"{driver}_segments_blocked")(
        [jnp.asarray(x) for x in segs], bvalid=jnp.asarray(bvalid),
        interpret=True, **kw)
    got = getattr(norm_agg, f"{driver}_segments_blocked")(
        [torch.as_tensor(x) for x in segs], bvalid=torch.as_tensor(bvalid),
        **kw)
    for a, b in zip(got, ref):
        _close(a, b, AGG_TOL if driver == "rfa" else 0)


# ---------------------------------------------------------------------------
# the backend with a validity mask
# ---------------------------------------------------------------------------

def _cfgs(rule, n):
    kw = {"n_byz": max(1, n // 10)} if rule in ("rfa", "krum") else {}
    return (types.SimpleNamespace(
                aggregator=jagg.get_aggregator(rule, bucket_size=2, **kw)),
            types.SimpleNamespace(
                aggregator=tagg.get_aggregator(rule, bucket_size=2, **kw)))


@pytest.mark.parametrize("n", [5, 130])
@pytest.mark.parametrize("rule", RULES)
def test_tree_aggregate_pallas_with_valid(rule, n):
    """Fused ALIE, NaN rows marked invalid: the fused kernels at n = 5, the
    giant-n tier (zeroed rows, masked bucketing, blocked drivers at m =
    65) at n = 130."""
    valid = _valid(n, n + len(rule))
    xs = _poisoned_tree(n, valid, n)
    rng = np.random.default_rng(n)
    mask = np.arange(n) < max(1, n // 10)
    means = {"b": rng.standard_normal(()).astype(np.float32),
             "w": rng.standard_normal((7, 3)).astype(np.float32)}
    stds = {k: np.abs(v) for k, v in means.items()}
    jcfg, tcfg = _cfgs(rule, n)
    ref = jax.jit(lambda xs, mask, means, stds, v: jsa.tree_aggregate_pallas(
        jcfg, jax.random.PRNGKey(7), xs,
        jsa.AttackCtx(fn=JCoordAttack("ALIE", ALIE_Z), mask=mask,
                      means=means, stds=stds), valid=v))(
            *(jax.tree.map(jnp.asarray, a)
              for a in (xs, mask, means, stds, valid)))
    ctx = tsa.AttackCtx(CoordAttack("ALIE", ALIE_Z), torch.as_tensor(mask),
                        tree_from_numpy(means), tree_from_numpy(stds))
    got = tsa.tree_aggregate_pallas(tcfg, R.PRNGKey(7), tree_from_numpy(xs),
                                    ctx, valid=torch.as_tensor(valid))
    for k in ref:
        _close(got[k], ref[k], 0 if rule in ("mean", "cm", "tm")
               else AGG_TOL)


# ---------------------------------------------------------------------------
# the wire under the guard
# ---------------------------------------------------------------------------

def _garbled_wire(n, d, k, seed):
    """(reference, port) WireCandidates of one leaf with a shared base;
    row 2's values NaN, row 4's indices garbled outside [0, d)."""
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([rng.permutation(d)[:k] for _ in range(n)]),
                  axis=1).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    vals[2] = np.nan
    idx[4] = rng.integers(-2 ** 31, 2 ** 31 - 1, k).astype(np.int32)
    idx[4, 0] = -1                      # counts from the end, as JAX's
    base = rng.standard_normal((1, d)).astype(np.float32)
    jwc = jwire.WireCandidates(
        fmt="sparse", n=n,
        payloads=({"vals": jnp.asarray(vals), "idx": jnp.asarray(idx)},),
        base=(jnp.asarray(base),), treedef=jax.tree.structure({"w": 0}),
        shapes=((d,),), dtypes=(jnp.float32,), src_dtypes=(jnp.float32,))
    twc = twire.WireCandidates(
        fmt="sparse", n=n,
        payloads=({"vals": torch.as_tensor(vals),
                   "idx": torch.as_tensor(idx)},),
        base=(torch.as_tensor(base),), names=("w",), shapes=((d,),),
        dtypes=(torch.float32,), src_dtypes=(torch.float32,))
    return jwc, twc


def test_payload_valid_and_decode_drop_garbled_rows():
    jwc, twc = _garbled_wire(6, 200, 20, 0)
    valid = guard.payload_valid(twc)
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(jguard.payload_valid(jwc)))
    assert valid.tolist() == [True, True, False, True, False, True]
    ref = np.asarray(jwire.reconstruct(jwc)["w"])
    got = twire.reconstruct(twc)["w"].numpy()
    np.testing.assert_array_equal(got, ref)


def test_wire_stats_sanitize():
    jwc, twc = _garbled_wire(6, 200, 20, 1)
    good = np.array([False, True, False, True, False, True])
    rm, rs = jwire.wire_stats(jwc, jnp.asarray(good), sanitize=True)
    tm, ts = twire.wire_stats(twc, torch.as_tensor(good), sanitize=True)
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(rm[0]), rtol=REL,
                               atol=REL)
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(rs[0]), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(tm[0].numpy()).all() and np.isfinite(
        ts[0].numpy()).all()
