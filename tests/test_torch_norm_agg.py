"""The port's norm-based aggregation (RFA, Krum) against the reference.

The plain kernel versions ``pair_gram_plain``, ``rfa_iter_plain`` and
``weighted_sum_plain`` (what the CPU path takes) are held to
``repro.kernels.norm_agg``'s kernels run in interpret mode on the same
numpy inputs, dense and from the sparse wire; the rule drivers and
``Aggregator.tree`` to theirs. Tolerances, each of the largest entry:
bit for bit where the value is a row sum without W (weighted_sum, and
RFA's z without bucketing: one fused multiply-add per row, in row order,
in both packages); 1e-6 where it goes through W (W @ x in another order);
1e-5 where it sums over d (a Gram entry, a squared distance): XLA's dot
takes the 2100 terms in an order a vectorized plain version cannot
repeat, and the two orders differ by up to 1.6e-6 here; 2e-5 for the RFA
rule, the reference's pallas≡gspmd tolerance. Krum's selected index is
identical everywhere. The CUDA kernels themselves are
held to the plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core.attacks import CoordAttack as JCoordAttack
from repro.kernels import norm_agg as jnorm
from repro.kernels import quantize as jq
from repro_torch import random as R
from repro_torch.core import aggregators as tagg
from repro_torch.core.attacks import CoordAttack
from repro_torch.kernels import _build, norm_agg, quantize

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

REL = 1e-6             # through W, in another order
SUM_REL = 1e-5         # sums over d, in another order
RFA_TOL = 2e-5         # the reference's pallas≡gspmd tolerance
ATTACK_PARAM = {"BF": 0.0, "ALIE": 1.06, "IPM": 0.1}


def _stats(n, d, rng):
    mean = rng.standard_normal(d).astype(np.float32)
    std = np.abs(rng.standard_normal(d)).astype(np.float32)
    mask = np.arange(n) < max(1, n // 4)
    return mean, std, mask


def _w(n, s, seed=0):
    """The reference's and the port's bucket operators for one
    permutation (equal bit for bit)."""
    if not s:
        return None, None
    perm = np.random.default_rng(seed + 100).permutation(n)
    wj = jnorm.bucket_matrix(jnp.asarray(perm), n, s)
    wt = norm_agg.bucket_matrix(torch.as_tensor(perm), n, s)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    return wj, wt


def _sparse(n, d, k, base_rows, rng):
    idx = np.sort(np.stack([rng.permutation(d)[:k] for _ in range(n)]),
                  axis=1).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    base = (None if base_rows == 0 else
            rng.standard_normal((base_rows, d)).astype(np.float32))
    jsrc = jq.WireSrc(fmt="sparse", n=n, d=d,
                      arrays=(("vals", jnp.asarray(vals)),
                              ("idx", jnp.asarray(idx))),
                      base=None if base is None else jnp.asarray(base))
    tsrc = quantize.WireSrc(fmt="sparse", n=n, d=d,
                            arrays=(("vals", torch.as_tensor(vals)),
                                    ("idx", torch.as_tensor(idx))),
                            base=None if base is None
                            else torch.as_tensor(base))
    return jsrc, tsrc


def _attack_kw(attack, mask, mean, std):
    """(JAX kwargs, port kwargs) of the fused attack."""
    if attack is None:
        return {}, {}
    jkw = dict(mask=jnp.asarray(mask), good_mean=jnp.asarray(mean),
               good_std=jnp.asarray(std),
               attack_fn=JCoordAttack(attack, ATTACK_PARAM[attack]))
    tkw = dict(mask=torch.as_tensor(mask), good_mean=torch.as_tensor(mean),
               good_std=torch.as_tensor(std),
               attack=CoordAttack(attack, ATTACK_PARAM[attack]))
    return jkw, tkw


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


def _all_three(jx, tx, n, s, attack, mask, mean, std, rng):
    """Each kernel of the module on one input, reference vs port."""
    wj, wt = _w(n, s)
    m = n if wt is None else wt.shape[0]
    jkw, tkw = _attack_kw(attack, mask, mean, std)
    wr = rng.random(m).astype(np.float32) + 0.1
    wr /= wr.sum()
    wn = rng.random(n).astype(np.float32)
    g = norm_agg.pair_gram_plain(tx, wt, **tkw)
    _close(g, jnorm.pair_gram(jx, wj, interpret=True, **jkw), SUM_REL)
    assert g.shape == (m, m)
    z, sq = norm_agg.rfa_iter_plain(tx, torch.as_tensor(wr), wt, **tkw)
    jz, jsq = jnorm.rfa_iter(jx, jnp.asarray(wr), wj, interpret=True, **jkw)
    _close(z, jz, 0 if wt is None else REL)
    _close(sq, jsq, SUM_REL)
    out = norm_agg.weighted_sum_plain(tx, torch.as_tensor(wn), **tkw)
    _close(out, jnorm.weighted_sum(jx, jnp.asarray(wn), interpret=True,
                                   **jkw), 0)


@pytest.mark.parametrize("attack", [None, "BF", "ALIE", "IPM"])
@pytest.mark.parametrize("s", [0, 2, 3])
@pytest.mark.parametrize("n", [5, 8])
def test_kernels_dense(n, s, attack):
    rng = np.random.default_rng(n * 10 + s)
    d = 2100
    x = rng.standard_normal((n, d)).astype(np.float32)
    mean, std, mask = _stats(n, d, rng)
    _all_three(jnp.asarray(x), torch.as_tensor(x), n, s, attack, mask, mean,
               std, rng)


@pytest.mark.parametrize("base", ["none", "shared", "per_worker"])
@pytest.mark.parametrize("s", [0, 2, 3])
@pytest.mark.parametrize("n", [5, 8])
def test_kernels_sparse_wire(n, s, base):
    rng = np.random.default_rng(n * 10 + s + 7)
    d = 2100
    base_rows = {"none": 0, "shared": 1, "per_worker": n}[base]
    jsrc, tsrc = _sparse(n, d, 210, base_rows, rng)
    mean, std, mask = _stats(n, d, rng)
    _all_three(jsrc, tsrc, n, s, "ALIE", mask, mean, std, rng)


@pytest.mark.parametrize("attack", [None, "BF", "IPM"])
def test_kernels_sparse_wire_other_attacks(attack):
    rng = np.random.default_rng(3)
    jsrc, tsrc = _sparse(5, 2100, 210, 1, rng)
    mean, std, mask = _stats(5, 2100, rng)
    _all_three(jsrc, tsrc, 5, 2, attack, mask, mean, std, rng)


def _segments(kind, n, rng):
    """Two segments of one logical stack, and its row 2 pulled towards
    the centre so that Krum's winner is clear."""
    dims = (300, 2100)
    if kind == "dense":
        segs = [rng.standard_normal((n, d)).astype(np.float32) for d in dims]
        for x in segs:
            x[2] *= 0.1
        return ([jnp.asarray(x) for x in segs],
                [torch.as_tensor(x) for x in segs], dims)
    pairs = [_sparse(n, d, d // 10, 1, rng) for d in dims]
    return [p[0] for p in pairs], [p[1] for p in pairs], dims


def _driver_inputs(kind, n, s):
    rng = np.random.default_rng(41 + s)
    jsegs, tsegs, dims = _segments(kind, n, rng)
    stats = [_stats(n, d, rng) for d in dims]
    mask = stats[0][2]
    wj, wt = _w(n, s)
    jkw = dict(w_mat=wj, mask=jnp.asarray(mask),
               means=[jnp.asarray(st[0]) for st in stats],
               stds=[jnp.asarray(st[1]) for st in stats],
               attack_fn=JCoordAttack("ALIE", 1.06), interpret=True)
    tkw = dict(w_mat=wt, mask=torch.as_tensor(mask),
               means=[torch.as_tensor(st[0]) for st in stats],
               stds=[torch.as_tensor(st[1]) for st in stats],
               attack=CoordAttack("ALIE", 1.06))
    return jsegs, tsegs, jkw, tkw


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("kind", ["dense", "wire"])
def test_rfa_segments(kind, s):
    jsegs, tsegs, jkw, tkw = _driver_inputs(kind, 12, s)
    ref = jnorm.rfa_segments(jsegs, iters=8, **jkw)
    got = norm_agg.rfa_segments(tsegs, iters=8, **tkw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RFA_TOL,
                                   atol=RFA_TOL)


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("kind", ["dense", "wire"])
def test_rfa_segments_reads_sq_alone(kind, s, monkeypatch):
    """Every Weiszfeld pass of the driver goes through the private
    ``_rfa_sq`` (the kernel then writes no z), counted as an ``rfa_iter``
    call, its sq that of the public ``rfa_iter``; the aggregate holds to
    the reference's ``rfa_segments`` (interpret mode) at 2e-5."""
    jsegs, tsegs, jkw, tkw = _driver_inputs(kind, 8, s)
    seen = []
    real = norm_agg._rfa_sq

    def spy(*args, **kw):
        sq = real(*args, **kw)
        _, want = norm_agg.rfa_iter(*args, **kw)
        assert torch.equal(sq, want)
        seen.append(sq.shape)
        return sq

    monkeypatch.setattr(norm_agg, "_rfa_sq", spy)
    calls = norm_agg.rfa_iter.calls
    got = norm_agg.rfa_segments(tsegs, iters=3, **tkw)
    ref = jnorm.rfa_segments(jsegs, iters=3, **jkw)
    assert seen == [(8 if s == 0 else 4,)] * (3 * len(tsegs))
    assert norm_agg.rfa_iter.calls == calls + 2 * len(seen)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RFA_TOL,
                                   atol=RFA_TOL)


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("kind", ["dense", "wire"])
def test_krum_segments(kind, s):
    jsegs, tsegs, jkw, tkw = _driver_inputs(kind, 12, s)
    ref, info = jnorm.krum_segments(jsegs, n_byz=1, return_info=True, **jkw)
    got = norm_agg.krum_segments(tsegs, n_byz=1, **tkw)
    g = sum(norm_agg.pair_gram_plain(x, tkw["w_mat"], tkw["mask"], mu, sd,
                                     attack=tkw["attack"])
            for x, mu, sd in zip(tsegs, tkw["means"], tkw["stds"]))
    _, scores, best = norm_agg.krum_select(g, 1)
    top2 = torch.sort(scores).values[:2]
    # a winner clear of the tolerance the scores are compared at
    assert float(top2[1] - top2[0]) > 10 * SUM_REL * float(top2[0])
    assert int(best) == int(info["krum_selected"])
    np.testing.assert_allclose(scores.numpy(), np.asarray(info["krum_scores"]),
                               rtol=SUM_REL)
    for a, b in zip(got, ref):
        _close(a, b, REL)


def _tree(n, seed):
    rng = np.random.default_rng(seed)
    xs = {"b": rng.standard_normal((n,)).astype(np.float32),
          "w": rng.standard_normal((n, 7, 3)).astype(np.float32)}
    xs["w"][1] *= 0.1
    xs["b"][1] *= 0.1
    return ({k: jnp.asarray(v) for k, v in xs.items()},
            {k: torch.as_tensor(v) for k, v in xs.items()})


def _row_of(out: dict, rows: dict) -> int:
    """Index of the stacked row ``out`` is closest to."""
    dist = sum(np.sum((np.asarray(rows[k]).reshape(rows[k].shape[0], -1)
                       - np.asarray(out[k]).reshape(1, -1)) ** 2, axis=1)
               for k in rows)
    return int(np.argmin(dist))


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("rule", ["rfa", "krum"])
def test_aggregator_tree(rule, s):
    jxs, txs = _tree(7, 4 + s)
    ref = jagg.get_aggregator(rule, bucket_size=s).tree(
        jax.random.PRNGKey(1), jxs)
    agg = tagg.get_aggregator(rule, bucket_size=s)
    assert agg.norm_based
    got = agg.tree(R.PRNGKey(1), txs)
    if rule == "rfa":
        for k in jxs:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=RFA_TOL, atol=RFA_TOL)
        return
    perm = R.permutation(R.PRNGKey(1), 7)
    rows = {k: (tagg._bucketize_perm(v, perm, s) if s else v)
            for k, v in txs.items()}
    assert _row_of(got, rows) == _row_of(ref, rows)
    for k in jxs:
        _close(got[k], ref[k], REL)


@pytest.mark.parametrize("rule", ["rfa", "krum"])
def test_aggregator_flat_call(rule):
    jxs, txs = _tree(6, 9)
    ref = jagg.get_aggregator(rule, bucket_size=2)(jax.random.PRNGKey(3),
                                                   jxs["w"].reshape(6, -1))
    got = tagg.get_aggregator(rule, bucket_size=2)(R.PRNGKey(3),
                                                   txs["w"].reshape(6, -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RFA_TOL,
                               atol=RFA_TOL)


def test_krum_over_64_rows_names_its_roadmap_item():
    """Krum over more than 64 rows runs, on the plain Gram; its masked twin
    (the fault guard's, ROADMAP queue 1, item 7) is ported too: with every
    row valid it is the unmasked Krum, and an invalid row never wins."""
    xs = {"w": torch.randn(65, 3, generator=torch.Generator().manual_seed(0))}
    out = tagg.get_aggregator("krum").tree(R.PRNGKey(0), xs)
    assert out["w"].shape == (3,) and torch.isfinite(out["w"]).all()
    every = torch.ones(65, dtype=torch.bool)
    torch.testing.assert_close(
        norm_agg.krum_segments_blocked([xs["w"]], bvalid=every)[0],
        norm_agg.krum_segments_blocked([xs["w"]])[0], rtol=0, atol=0)
    _, _, best = norm_agg.krum_select(
        norm_agg.pair_gram_blocked(xs["w"]), 1)
    drop = every.clone()
    drop[best] = False
    _, scores, best2 = norm_agg.krum_select(
        norm_agg.pair_gram_blocked(xs["w"]), 1, drop)
    assert int(best2) != int(best) and torch.isinf(scores[best])


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((5, 300)).astype(np.float32))
    w = torch.full((5,), 0.2)
    fns = (norm_agg.pair_gram, norm_agg.rfa_iter, norm_agg.weighted_sum)
    before = [(f.calls, f.launches) for f in fns]
    torch.testing.assert_close(norm_agg.pair_gram(x),
                               norm_agg.pair_gram_plain(x), rtol=0, atol=0)
    for a, b in zip(norm_agg.rfa_iter(x, w), norm_agg.rfa_iter_plain(x, w)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(norm_agg.weighted_sum(x, w),
                               norm_agg.weighted_sum_plain(x, w), rtol=0,
                               atol=0)
    assert [(f.calls, f.launches) for f in fns] == [
        (c + 1, l) for c, l in before]
    with pytest.raises(ValueError, match="unsupported device"):
        norm_agg.weighted_sum(x.to("meta"), w.to("meta"))


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.sources()}
    assert set(before) == {"block_quantize", "norm_agg", "norm_agg_blocked",
                           "robust_agg", "topk_select"}
    header = csrc / "agg_prologue.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.sources()}
    assert all(after[k] != before[k] for k in before)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("norm_agg") != after["norm_agg"]
