"""The port's giant-n tier (more than 64 workers) against the reference.

The plain blocked kernels ``pair_gram_blocked_plain``,
``sqdist_to_blocked_plain`` and ``weighted_sum_blocked_plain`` (what the
CPU path takes) are held to ``repro.kernels.norm_agg``'s blocked kernels
run in interpret mode on the same numpy inputs; the blocked drivers to
the reference's; the gspmd Gram at n > 64 to the reference's jnp slab
oracle; and
``sharded_agg.tree_aggregate_pallas`` / ``tree_aggregate_pallas_wire`` to
the reference's at n = 100 (m = 50 bucketed rows: the fused drivers) and
n = 130 (m = 65: the blocked ones), for all five rules.

Tolerances, each of the largest entry: bit for bit for the weighted sum
and the coordinate rules (the plain versions repeat the order in which
the reference's compiled code sums rows on the CPU); 1e-5 for the Gram
and the squared distances, sums over d that XLA takes in an order no
vectorized plain version repeats; 2e-5, the reference's pallas≡gspmd
tolerance, for the RFA and Krum aggregates. Krum's selected row is
identical. The CUDA kernels themselves are held to the plain versions on
the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import compressors as jcomp
from repro.core import sharded_agg as jsa
from repro.core import wire as jwire
from repro.core.attacks import CoordAttack as JCoordAttack
from repro.kernels import norm_agg as jnorm
from repro_torch import random as R
from repro_torch.convert import key_from_numpy, tree_from_numpy
from repro_torch.core import aggregators as tagg
from repro_torch.core import compressors as tcomp
from repro_torch.core import sharded_agg as tsa
from repro_torch.core import wire as twire
from repro_torch.core.attacks import CoordAttack
from repro_torch.kernels import norm_agg

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

SUM_REL = 1e-5         # sums over d, in another order
AGG_TOL = 2e-5         # the reference's pallas≡gspmd tolerance
ALIE_Z = 1.06


def _close(got, ref, rel):
    """Agreement to ``rel`` of the largest entry; 0 means bit for bit."""
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if rel == 0:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=rel * max(1.0, np.abs(ref).max()))


def _stack(m, d, seed):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(
        np.float32)


@pytest.mark.parametrize("d", [1, 123, 2100])
@pytest.mark.parametrize("m", [65, 75, 130, 150])
def test_pair_gram_blocked(m, d):
    x = _stack(m, d, m + d)
    got = norm_agg.pair_gram_blocked_plain(torch.as_tensor(x))
    _close(got, jnorm.pair_gram_blocked(jnp.asarray(x), interpret=True),
           SUM_REL)
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("d", [1, 123, 2100])
@pytest.mark.parametrize("m", [65, 75, 130, 150])
def test_sqdist_to_blocked(m, d):
    x = _stack(m, d, m + d)
    z = _stack(1, d, d)[0]
    _close(norm_agg.sqdist_to_blocked_plain(torch.as_tensor(x),
                                            torch.as_tensor(z)),
           jnorm.sqdist_to_blocked(jnp.asarray(x), jnp.asarray(z),
                                   interpret=True), SUM_REL)


@pytest.mark.parametrize("d", [1, 123, 2100])
@pytest.mark.parametrize("m", [65, 75, 130, 150])
def test_weighted_sum_blocked(m, d):
    x = _stack(m, d, m + d)
    w = np.random.default_rng(m).random(m).astype(np.float32)
    _close(norm_agg.weighted_sum_blocked_plain(torch.as_tensor(x),
                                               torch.as_tensor(w)),
           jnorm.weighted_sum_blocked(jnp.asarray(x), jnp.asarray(w),
                                      interpret=True), 0)


@pytest.mark.parametrize("m", [20, 40, 64])
def test_weighted_sum_blocked_refuses_the_fused_tier(m):
    """Its order is the reference's for 64-row worker tiles, which the
    reference takes only above 64 rows."""
    x = torch.as_tensor(_stack(m, 30, m))
    w = torch.full((m,), 1 / m)
    for fn in (norm_agg.weighted_sum_blocked,
               norm_agg.weighted_sum_blocked_plain):
        with pytest.raises(ValueError, match="more than 64 rows"):
            fn(x, w)


def _segments(m, seed):
    """Two dense segments of one logical stack, row 3 pulled towards the
    centre so that Krum's winner is clear."""
    rng = np.random.default_rng(seed)
    segs = [rng.standard_normal((m, d)).astype(np.float32) for d in (1, 300)]
    for x in segs:
        x[3] *= 0.1
    return segs


@pytest.mark.parametrize("m", [65, 130])
def test_rfa_segments_blocked(m):
    segs = _segments(m, 11)
    ref = jnorm.rfa_segments_blocked([jnp.asarray(x) for x in segs],
                                     iters=8, interpret=True)
    got = norm_agg.rfa_segments_blocked([torch.as_tensor(x) for x in segs],
                                        iters=8)
    for a, b in zip(got, ref):
        _close(a, b, AGG_TOL)


@pytest.mark.parametrize("m", [65, 130])
def test_krum_segments_blocked(m):
    segs = _segments(m, 12)
    ref, info = jnorm.krum_segments_blocked(
        [jnp.asarray(x) for x in segs], n_byz=m // 10, interpret=True,
        return_info=True)
    tsegs = [torch.as_tensor(x) for x in segs]
    got = norm_agg.krum_segments_blocked(tsegs, n_byz=m // 10)
    g = sum(norm_agg.pair_gram_blocked_plain(x) for x in tsegs)
    _, scores, best = norm_agg.krum_select(g, m // 10)
    assert int(best) == int(info["krum_selected"]) == 3
    np.testing.assert_allclose(scores.numpy(), np.asarray(info["krum_scores"]),
                               rtol=SUM_REL)
    for a, b in zip(got, ref):
        _close(a, b, 0)


@pytest.mark.parametrize("driver", ["rfa", "krum"])
def test_blocked_drivers_with_a_validity_mask_name_their_roadmap_item(
        driver):
    """The validity mask of ROADMAP queue 1, item 7, now ported: the
    blocked drivers with ``bvalid`` follow the reference's, and the
    invalid rows (zeroed, as the giant-n tier hands them over) neither
    win Krum nor carry RFA weight."""
    segs = _segments(65, 13)
    bvalid = np.ones(65, bool)
    bvalid[[0, 7, 64]] = False
    for x in segs:
        x[~bvalid] = 0.0
    jfn = getattr(jnorm, f"{driver}_segments_blocked")
    fn = getattr(norm_agg, f"{driver}_segments_blocked")
    kw = {"iters": 8} if driver == "rfa" else {"n_byz": 6}
    ref = jfn([jnp.asarray(x) for x in segs], bvalid=jnp.asarray(bvalid),
              interpret=True, **kw)
    got = fn([torch.as_tensor(x) for x in segs],
             bvalid=torch.as_tensor(bvalid), **kw)
    for a, b in zip(got, ref):
        _close(a, b, AGG_TOL if driver == "rfa" else 0)


@pytest.mark.parametrize("n", [65, 130, 200])
def test_tree_pair_sqdists_blocked(n):
    rng = np.random.default_rng(n)
    xs = {"b": rng.standard_normal((n,)).astype(np.float32),
          "w": rng.standard_normal((n, 7, 3)).astype(np.float32)}
    ref = jagg._tree_pair_sqdists({k: jnp.asarray(v) for k, v in xs.items()})
    _close(tagg._tree_pair_sqdists(tree_from_numpy(xs)), ref, SUM_REL)


def _cfgs(rule, n):
    kw = {"n_byz": n // 10} if rule in ("rfa", "krum") else {}
    return (types.SimpleNamespace(
                aggregator=jagg.get_aggregator(rule, bucket_size=2, **kw)),
            types.SimpleNamespace(
                aggregator=tagg.get_aggregator(rule, bucket_size=2, **kw)))


def _stats(n, shapes, rng):
    mask = np.arange(n) < n // 10
    means = {k: rng.standard_normal(sh).astype(np.float32)
             for k, sh in shapes.items()}
    stds = {k: np.abs(rng.standard_normal(sh)).astype(np.float32)
            for k, sh in shapes.items()}
    return mask, means, stds


def _jctx(mask, means, stds):
    return jsa.AttackCtx(fn=JCoordAttack("ALIE", ALIE_Z), mask=mask,
                         means=means, stds=stds)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _agree(rule, got, ref):
    tol = 0 if rule in ("mean", "cm", "tm") else AGG_TOL
    for k in ref:
        _close(got[k], ref[k], tol)


RULES = ["mean", "cm", "tm", "rfa", "krum"]


@pytest.mark.parametrize("n", [100, 130])
@pytest.mark.parametrize("rule", RULES)
def test_tree_aggregate_pallas_giant_n(rule, n):
    rng = np.random.default_rng(n + len(rule))
    xs = {"b": rng.standard_normal((n,)).astype(np.float32),
          "w": rng.standard_normal((n, 7, 3)).astype(np.float32)}
    xs["w"][5] *= 0.1
    mask, means, stds = _stats(n, {"b": (), "w": (7, 3)}, rng)
    jcfg, tcfg = _cfgs(rule, n)
    # jitted, as the reference's engine step runs it (ALIE's value is one
    # fused multiply-add only when compiled)
    ref = jax.jit(lambda xs, mask, means, stds: jsa.tree_aggregate_pallas(
        jcfg, jax.random.PRNGKey(7), xs, _jctx(mask, means, stds)))(
            _jnp(xs), _jnp(mask), _jnp(means), _jnp(stds))
    ctx = tsa.AttackCtx(CoordAttack("ALIE", ALIE_Z), torch.as_tensor(mask),
                        tree_from_numpy(means), tree_from_numpy(stds))
    got = tsa.tree_aggregate_pallas(tcfg, R.PRNGKey(7), tree_from_numpy(xs),
                                    ctx)
    _agree(rule, got, ref)


@pytest.mark.parametrize("n", [100, 130])
@pytest.mark.parametrize("rule", RULES)
def test_tree_aggregate_pallas_wire_giant_n(rule, n):
    rng = np.random.default_rng(n + 3 * len(rule))
    dim = 120
    stacked = {"b": rng.standard_normal((n,)).astype(np.float32),
               "w": rng.standard_normal((n, dim)).astype(np.float32)}
    base = {"b": rng.standard_normal(()).astype(np.float32),
            "w": rng.standard_normal((dim,)).astype(np.float32)}
    jkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(n), i))(jnp.arange(n))
    jw = jwire.pack_candidates(
        jcomp.rand_k(0.1), jkeys,
        {k: jnp.asarray(v) for k, v in stacked.items()},
        base={k: jnp.asarray(v) for k, v in base.items()}, base_shared=True)
    tw = twire.pack_candidates(
        tcomp.rand_k(0.1), key_from_numpy(jkeys), tree_from_numpy(stacked),
        base=tree_from_numpy(base), base_shared=True)
    mask, means, stds = _stats(n, {"b": (), "w": (dim,)}, rng)
    names = ("b", "w")
    flat_means = [means[k].reshape(-1) for k in names]
    flat_stds = [stds[k].reshape(-1) for k in names]
    jcfg, tcfg = _cfgs(rule, n)
    ref = jax.jit(lambda wc, mask, means, stds: jsa.tree_aggregate_pallas_wire(
        jcfg, jax.random.PRNGKey(5), wc, _jctx(mask, means, stds)))(
            jw, _jnp(mask), _jnp(flat_means), _jnp(flat_stds))
    tctx = tsa.AttackCtx(CoordAttack("ALIE", ALIE_Z), torch.as_tensor(mask),
                         [torch.as_tensor(v) for v in flat_means],
                         [torch.as_tensor(v) for v in flat_stds])
    got = tsa.tree_aggregate_pallas_wire(tcfg, R.PRNGKey(5), tw, tctx)
    _agree(rule, got, ref)


@pytest.mark.parametrize("rule", ["rfa", "krum"])
def test_giant_n_routes_by_bucketed_rows(rule):
    """m <= 64 bucketed rows take the fused drivers, m > 64 the blocked
    ones; the tier never calls a fused kernel on more than 64 rows."""
    fns = [norm_agg.pair_gram, norm_agg.rfa_iter, norm_agg.weighted_sum,
           norm_agg.pair_gram_blocked, norm_agg.sqdist_to_blocked,
           norm_agg.weighted_sum_blocked]
    seen = {}
    for n in (100, 130):
        xs = {"b": torch.randn(n), "w": torch.randn(n, 5)}
        before = [f.calls for f in fns]
        tsa.tree_aggregate_pallas(_cfgs(rule, n)[1], R.PRNGKey(0), xs)
        seen[n] = [f.calls - b for f, b in zip(fns, before)]
    blocked = {"rfa": [0, 0, 0, 0, 16, 18], "krum": [0, 0, 0, 2, 0, 2]}
    fused = {"rfa": [0, 16, 2, 0, 0, 0], "krum": [2, 0, 2, 0, 0, 0]}
    assert seen == {100: fused[rule], 130: blocked[rule]}


def test_cpu_tensors_take_the_plain_versions():
    x = torch.as_tensor(_stack(70, 300, 1))
    z = torch.as_tensor(_stack(1, 300, 2)[0])
    w = torch.full((70,), 1 / 70)
    fns = (norm_agg.pair_gram_blocked, norm_agg.sqdist_to_blocked,
           norm_agg.weighted_sum_blocked)
    before = [(f.calls, f.launches) for f in fns]
    assert torch.equal(norm_agg.pair_gram_blocked(x),
                       norm_agg.pair_gram_blocked_plain(x))
    assert torch.equal(norm_agg.sqdist_to_blocked(x, z),
                       norm_agg.sqdist_to_blocked_plain(x, z))
    assert torch.equal(norm_agg.weighted_sum_blocked(x, w),
                       norm_agg.weighted_sum_blocked_plain(x, w))
    assert [(f.calls, f.launches) for f in fns] == [
        (c + 1, l) for c, l in before]
    with pytest.raises(ValueError, match="unsupported device"):
        norm_agg.weighted_sum_blocked(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("m, d", [(65, 1), (128, 123), (128, 1 << 22),
                                  (1024, 1 << 20), (4096, 1 << 16),
                                  (4096, 1 << 22), (150, 2100)])
def test_kernel_plans_cover_d_and_bound_the_workspace(m, d):
    """Both plans cover d with whole steps (the Gram's chunks with whole
    column tiles of the reference, where its running sums restart), keep
    the one-launch finish's tickets and workspace in bounds, and at full
    width fill the waves of Gram blocks (one a 128-row tile pair and chunk,
    alone on an SM) they take on the card's 132 SMs to 90% or more."""
    nt = -(-m // 128)
    pairs = nt * (nt + 1) // 2
    chunks, cols, tile = norm_agg.gram_plan(m, d)
    assert tile == norm_agg._tile_for(d) and cols % tile == 0
    assert (chunks - 1) * cols < d <= chunks * cols
    groups = -(-chunks // 16)
    assert chunks == 1 or (pairs * (groups + 1) <= 4096 and
                           pairs * (chunks + groups) * 128 * 136 * 4
                           <= 256 << 20)
    if d >= 1 << 16:                      # full width: the card is filled
        blocks = chunks * pairs
        assert blocks >= 0.9 * 132 * -(-blocks // 132)
    chunks, cols = norm_agg.sqdist_plan(m, d)
    assert cols % 128 == 0 and (chunks - 1) * cols < d <= chunks * cols
    assert chunks < 65536
    assert norm_agg.finish_fits(-(-m // 8), chunks, 8)
