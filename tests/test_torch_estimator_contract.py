"""Port twin of the estimator conformance harness
(``tests/test_estimator_contract.py``), over every entry of the port's
``ESTIMATORS``:

  * the trait registries cover every estimator, with the reference's
    traits;
  * ``run(spec)`` ≡ the hand-wired engine (``spec.build_config()`` +
    ``make_method`` + the runner's key schedule) bit for bit;
  * communication accounting ≡ ``theory.comm_bits_per_round``, also under
    partial participation;
  * descent on a deterministic quadratic;
  * the pallas backend ≡ gspmd at 2e-5;
  * the measured wire bits ≡ theory.

And the ``core/baselines.py`` makers, with the checks of
``tests/test_baselines.py`` over fewer iterations, each held to the
reference's maker on the same inputs. The harness's checkpoint round trip
is left out: checkpoints are not ported yet (ROADMAP queue 1, item 9).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import (ByzVRMarinaConfig as JaxConfig,
                        get_aggregator as jax_get_aggregator,
                        get_attack as jax_get_attack,
                        get_compressor as jax_get_compressor)
from repro.core import estimators as JE
from repro.data import (corrupt_labels_logreg as jax_corrupt,
                        logreg_loss as jax_logreg_loss,
                        make_logreg_data as jax_make_logreg_data)
from repro_torch import random as R
from repro_torch.api import RunSpec, run
from repro_torch.convert import key_from_numpy
from repro_torch.core import baselines as B
from repro_torch.core import estimators as E
from repro_torch.core import theory, tree_utils as tu
from repro_torch.core.aggregators import get_aggregator
from repro_torch.core.attacks import get_attack
from repro_torch.core.byz_vr_marina import ByzVRMarinaConfig
from repro_torch.core.compressors import get_compressor
from repro_torch.core.engine import list_methods, make_method
from repro_torch.data import (corrupt_labels_logreg, init_logreg_params,
                              logreg_loss, make_logreg_data)

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

KEY = R.PRNGKey(11)
DIM = 8
N = 5
STEPS = 5
BATCH = 8

METHODS = list_methods()

# canonical per-method spec tweaks: byz_ef21 needs a contractive
# compressor, svrg's paper pairing is RFA, saga's table stays toy-sized
_METHOD_KW = {
    "byz_ef21": {"compressor": "topk",
                 "compressor_kwargs": {"ratio": 0.5}},
    "svrg": {"aggregator": "rfa"},
    "saga": {"method_kwargs": {"batch_size": 8}},
}


def _spec(method, **kw):
    base = dict(task="logreg", method=method, n_workers=N, n_byz=1, p=0.3,
                lr=0.25, attack="ALIE", aggregator="cm", bucket_size=2,
                compressor="randk", compressor_kwargs={"ratio": 0.5},
                steps=STEPS, seed=3,
                data_kwargs={"n_samples": 60, "dim": DIM,
                             "batch_size": BATCH, "data_seed": 0})
    base.update(_METHOD_KW.get(method, {}))
    base.update(kw)
    return RunSpec(**base)


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# registry coherence
# ---------------------------------------------------------------------------

def test_trait_registries_cover_every_estimator():
    assert set(E.ESTIMATOR_CLASSES) == set(E.ESTIMATORS)
    assert set(theory.BITS_FAMILY) == set(E.ESTIMATORS)
    assert set(E.ESTIMATORS) == set(JE.ESTIMATORS)
    assert E.seed_batchable("not-a-method") is False
    assert E.streamable("not-a-method") is False
    assert E.needs_contractive_compressor("byz_ef21") is True
    assert E.needs_contractive_compressor("marina") is False
    assert E.needs_contractive_compressor("not-a-method") is False


@pytest.mark.parametrize("method", METHODS)
def test_traits_match_the_reference(method):
    for trait in ("seed_batchable", "streamable",
                  "needs_contractive_compressor"):
        assert getattr(E, trait)(method) == getattr(JE, trait)(method), trait
    for attr in ("name", "rng", "update_params_first"):
        assert getattr(E.ESTIMATOR_CLASSES[method], attr) == \
            getattr(JE.ESTIMATOR_CLASSES[method], attr), attr


# ---------------------------------------------------------------------------
# run(spec) ≡ hand-wired engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_run_spec_matches_hand_wired_engine(method):
    spec = _spec(method)
    result = run(spec, device="cpu", log_every=1)

    data = make_logreg_data(
        R.PRNGKey(spec.data_kwargs["data_seed"]),
        n_samples=spec.data_kwargs["n_samples"], dim=DIM, n_workers=N,
        homogeneous=True)
    m = make_method(spec.method, spec.build_config(), logreg_loss(0.01),
                    corrupt_labels_logreg, **spec.method_kwargs)
    anchor = data.stacked()
    _, k_run = R.split(R.PRNGKey(spec.seed))
    state = m.init(init_logreg_params(DIM), anchor, k_run)
    losses = []
    for it in range(spec.steps):
        k_step, k_batch = R.split(R.fold_in(k_run, it + 1))
        state, met = m.step(state, data.sample_batches(k_batch, BATCH),
                            anchor, k_step)
        losses.append(float(met["loss"]))
    _assert_trees_equal(state["params"], result.params)
    _assert_trees_equal(state["g"], result.state["g"])
    assert losses == [h["loss"] for h in result.history]


# ---------------------------------------------------------------------------
# communication accounting ≡ theory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_comm_accounting_matches_theory(method):
    spec = _spec(method)
    cfg = spec.build_config()
    est = E.get_estimator(spec.method, cfg, **spec.method_kwargs)
    for d in (64, 937):
        expected = est.expected_bits(cfg, d)
        assert expected == pytest.approx(
            theory.comm_bits_per_round(method, cfg.compressor, d, p=cfg.p))
        mix = (cfg.p * est.round_bits(cfg, d, True)
               + (1 - cfg.p) * est.round_bits(cfg, d, False))
        assert expected == pytest.approx(mix)
        assert est.round_bits(cfg, d, True) > 0


@pytest.mark.parametrize("method", ["marina", "sgd", "byz_ef21", "diana",
                                    "saga"])
def test_comm_accounting_under_partial_participation(method):
    part = 3
    full = run(_spec(method), device="cpu", log_every=1)
    sampled = run(_spec(method, participation=part), device="cpu",
                  log_every=1)
    assert sampled.comm_bits == pytest.approx(full.comm_bits * part / N,
                                              rel=1e-12)
    cfg = _spec(method, participation=part).build_config()
    d = full.n_params
    assert theory.comm_bits_per_round(
        method, cfg.compressor, d, p=cfg.p, participation=part / N) == \
        pytest.approx(part / N * theory.comm_bits_per_round(
            method, cfg.compressor, d, p=cfg.p))


# ---------------------------------------------------------------------------
# descent on the deterministic quadratic
# ---------------------------------------------------------------------------

def _quadratic_problem():
    """Full-batch least squares: the batch is the anchor, so the only
    randomness left is the estimators' own coins and compressors."""
    kx, kw = R.split(R.PRNGKey(5))
    x = R.normal(kx, (N, 12, 6)) / math.sqrt(6.0)
    y = x @ R.normal(kw, (6,))
    anchor = {"x": x, "y": y}

    def qloss(params, batch, key=None):
        r = batch["x"] @ params["w"] - batch["y"]
        return 0.5 * (r * r).mean() + 0.005 * (params["w"] ** 2).sum()

    return anchor, qloss, {"w": torch.zeros(6)}


@pytest.mark.parametrize("method", METHODS)
def test_descends_on_deterministic_quadratic(method):
    anchor, qloss, params0 = _quadratic_problem()
    spec = _spec(method)
    cfg = ByzVRMarinaConfig(
        n_workers=N, n_byz=1, p=0.3, lr=0.3,
        aggregator=get_aggregator(spec.aggregator, bucket_size=2),
        compressor=get_compressor(spec.compressor,
                                  **spec.compressor_kwargs),
        attack=get_attack("NA"))
    m = make_method(method, cfg, qloss, **spec.method_kwargs)
    state = m.init(params0, anchor, KEY)
    full = {"x": anchor["x"].reshape(-1, 6), "y": anchor["y"].reshape(-1)}
    l0 = float(qloss(state["params"], full))
    k = KEY
    for _ in range(80):
        k, k_step = R.split(k)
        state, met = m.step(state, anchor, anchor, k_step)
        assert math.isfinite(float(met["loss"])), method
    l1 = float(qloss(state["params"], full))
    assert l1 < 0.5 * l0, (method, l0, l1)


# ---------------------------------------------------------------------------
# pallas ≡ gspmd, and the wire's bits ≡ theory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_pallas_backend_matches_gspmd(method):
    results = {mode: run(_spec(method, agg_mode=mode), device="cpu",
                         log_every=1) for mode in ("gspmd", "pallas")}
    for h_g, h_p in zip(results["gspmd"].history,
                        results["pallas"].history):
        assert set(h_g) == set(h_p)
        for k in set(h_g) - {"wall_s"}:
            np.testing.assert_allclose(h_g[k], h_p[k], atol=2e-5, rtol=2e-5,
                                       err_msg=k)
    for k in results["gspmd"].params:
        np.testing.assert_allclose(results["gspmd"].params[k].numpy(),
                                   results["pallas"].params[k].numpy(),
                                   atol=2e-5, rtol=2e-5)


WIRE_METHODS = sorted(m for m in METHODS if theory.BITS_FAMILY[m] != "dense")


@pytest.mark.parametrize("method", WIRE_METHODS)
def test_wire_bytes_match_theory(method):
    spec = _spec(method, agg_mode="pallas")
    res = run(spec, device="cpu", log_every=1)
    cfg = spec.build_config()
    dims = [p.numel() for p in tu.leaves(res.params)]
    want_bits = theory.comm_bits_per_round(method, cfg.compressor, 0,
                                           p=cfg.p, dims=dims)
    wb = [float(h["wire_bits"]) for h in res.history]
    assert len(wb) == STEPS
    if theory.BITS_FAMILY[method] == "vr_switch":
        dense = 32.0 * sum(dims)
        bits_q = float(cfg.compressor.tree_bits(dims))
        for b in wb:
            assert b == pytest.approx(dense) or b == pytest.approx(bits_q)
        assert want_bits == pytest.approx(
            cfg.p * dense + (1 - cfg.p) * bits_q)
    else:
        for b in wb:
            assert b / 8.0 == pytest.approx(want_bits / 8.0)


# ---------------------------------------------------------------------------
# the baselines' makers, against the reference's
# ---------------------------------------------------------------------------

BL_DIM = 15
BL_ITERS = 60


@pytest.fixture(scope="module")
def problem():
    jdata = jax_make_logreg_data(jax.random.PRNGKey(0), n_samples=300,
                                 dim=BL_DIM, n_workers=5, homogeneous=True)
    tdata = make_logreg_data(R.PRNGKey(0), n_samples=300, dim=BL_DIM,
                             n_workers=5, homogeneous=True)
    assert np.array_equal(tdata.features.numpy(), np.asarray(jdata.features))
    return jdata, tdata


def _cfgs(aggregator="cm", compressor=None, **kw):
    """The same config in both packages (``compressor`` a (name, kwargs)
    pair)."""
    base = dict(n_workers=5, n_byz=1, lr=0.3, p=0.1)
    base.update(kw)
    attack = "ALIE" if base["n_byz"] else "NA"
    bucket = 0 if aggregator == "mean" else 2
    jkw = dict(base, aggregator=jax_get_aggregator(aggregator,
                                                   bucket_size=bucket),
               attack=jax_get_attack(attack))
    tkw = dict(base, aggregator=get_aggregator(aggregator,
                                               bucket_size=bucket),
               attack=get_attack(attack))
    if compressor is not None:
        name, ckw = compressor
        jkw["compressor"] = jax_get_compressor(name, **ckw)
        tkw["compressor"] = get_compressor(name, **ckw)
    return JaxConfig(**jkw), ByzVRMarinaConfig(**tkw)


def _descends_like_reference(problem, jinit, jstep, tinit, tstep):
    """BL_ITERS steps of each package on the same minibatches and keys:
    the port's loss on the full data falls by 0.02, and its params stay
    within 2e-5 of the reference's."""
    jdata, tdata = problem
    janchor, tanchor = jdata.stacked(), tdata.stacked()
    tfull = {"x": tdata.features, "y": tdata.labels}
    loss_fn = logreg_loss(0.01)
    l0 = float(loss_fn(tinit["params"], tfull))
    jstep = jax.jit(jstep)
    js, ts = jinit, tinit
    k = jax.random.PRNGKey(0)
    for _ in range(BL_ITERS):
        k, k1, k2 = jax.random.split(k, 3)
        js, _ = jstep(js, jdata.sample_batches(k1, 16), janchor, k2)
        ts, tm = tstep(ts, tdata.sample_batches(key_from_numpy(k1), 16),
                       tanchor, key_from_numpy(k2))
        assert math.isfinite(float(tm["loss"]))
    for name in js["params"]:
        np.testing.assert_allclose(ts["params"][name].numpy(),
                                   np.asarray(js["params"][name]),
                                   rtol=2e-5, atol=2e-5)
    l1 = float(loss_fn(ts["params"], tfull))
    assert l1 < l0 - 0.02, (l0, l1)


def _params0():
    return ({"w": jnp.zeros(BL_DIM), "b": jnp.zeros(())},
            init_logreg_params(BL_DIM))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_makers(problem, momentum):
    """Parallel-SGD (mean, no byzantine) and BR-SGDm."""
    jcfg, tcfg = (_cfgs("mean", n_byz=0) if momentum == 0.0 else _cfgs())
    jinit, jstep = JB.make_sgd_step(jcfg, jax_logreg_loss(0.01), jax_corrupt,
                                    momentum=momentum)
    tinit, tstep = B.make_sgd_step(tcfg, logreg_loss(0.01),
                                   corrupt_labels_logreg, momentum=momentum)
    jp, tp = _params0()
    _descends_like_reference(problem, jinit(jp), jstep, tinit(tp), tstep)


def test_br_csgd_maker(problem):
    jcfg, tcfg = _cfgs(compressor=("randk", {"ratio": 0.2}))
    jinit, jstep = JB.make_csgd_step(jcfg, jax_logreg_loss(0.01),
                                     jax_corrupt)
    tinit, tstep = B.make_csgd_step(tcfg, logreg_loss(0.01),
                                    corrupt_labels_logreg)
    jp, tp = _params0()
    _descends_like_reference(problem, jinit(jp), jstep, tinit(tp), tstep)


def test_br_diana_maker(problem):
    jcfg, tcfg = _cfgs(compressor=("randk", {"ratio": 0.2}), lr=0.2)
    jinit, jstep = JB.make_diana_step(jcfg, jax_logreg_loss(0.01),
                                      jax_corrupt)
    tinit, tstep = B.make_diana_step(tcfg, logreg_loss(0.01),
                                     corrupt_labels_logreg)
    jp, tp = _params0()
    js, ts = jinit(jp, d_hint=BL_DIM + 1), tinit(tp, d_hint=BL_DIM + 1)
    assert float(ts["alpha"]) == float(js["alpha"])
    _descends_like_reference(problem, js, jstep, ts, tstep)


@pytest.mark.parametrize("maker", ["make_byrd_svrg_step", "make_br_mvr_step"])
def test_anchor_makers(problem, maker):
    """Byrd-SVRG (RFA, as the paper pairs it) and BR-MVR, whose init takes
    the anchor and a key."""
    jdata, tdata = problem
    jcfg, tcfg = _cfgs("rfa" if maker == "make_byrd_svrg_step" else "cm")
    jinit, jstep = getattr(JB, maker)(jcfg, jax_logreg_loss(0.01),
                                      jax_corrupt)
    tinit, tstep = getattr(B, maker)(tcfg, logreg_loss(0.01),
                                     corrupt_labels_logreg)
    jp, tp = _params0()
    key = jax.random.PRNGKey(0)
    _descends_like_reference(
        problem, jax.jit(jinit)(jp, jdata.stacked(), key), jstep,
        tinit(tp, tdata.stacked(), key_from_numpy(key)), tstep)


def test_byrd_saga_maker(problem):
    """The bespoke per-sample-gradient-table interface: the same slots and
    keys in both packages, a few steps, every table to 2e-5."""
    jdata, tdata = problem
    jcfg, tcfg = _cfgs()
    m = jdata.features.shape[0]

    def jgrad(p, x, y):
        return jax.grad(lambda q: jax_logreg_loss(0.01)(
            q, {"x": x[None], "y": y[None]}))(p)

    def tgrad(p, x, y):
        return torch.func.grad(lambda q: logreg_loss(0.01)(
            q, {"x": x[None], "y": y[None]}))(p)

    jp, tp = _params0()
    jinit, jstep = JB.make_byrd_saga_step(jcfg, jgrad, m, jp, jax_corrupt)
    tinit, tstep = B.make_byrd_saga_step(tcfg, tgrad, m, tp,
                                         corrupt_labels_logreg)
    jd, td = jdata.stacked(), tdata.stacked()
    js, ts = jinit(jp, jd), tinit(tp, td)
    jstep = jax.jit(jstep)
    rng = np.random.default_rng(0)
    for it in range(4):
        idx = np.stack([rng.permutation(m)[:16] for _ in range(5)])
        key = jax.random.PRNGKey(it)
        js, jm = jstep(js, jd, jnp.asarray(idx, jnp.int32), key)
        ts, tm = tstep(ts, td, torch.as_tensor(idx), key_from_numpy(key))
        np.testing.assert_allclose(float(tm["g_norm"]), float(jm["g_norm"]),
                                   rtol=2e-5, atol=2e-5)
        for part in ("params", "tables", "table_means"):
            for name, v in js[part].items():
                np.testing.assert_allclose(ts[part][name].numpy(),
                                           np.asarray(v), rtol=2e-5,
                                           atol=2e-5, err_msg=part)
