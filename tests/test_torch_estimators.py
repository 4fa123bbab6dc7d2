"""The method zoo's estimators (sgd, sgdm, csgd, diana, mvr, svrg,
cmfilter, saga) against the reference, one engine step at a time.

The reference's state is carried across by ``convert`` before every step,
as in ``tests/test_torch_ef21.py``, on ``agg_mode`` gspmd and pallas (the
reference's kernels in interpret mode, its step under ``jax.jit`` as its
runner compiles it). Loss, params, g and every estimator state entry
agree to 2e-5, the reference's pallas≡gspmd tolerance; DIANA's alpha,
SVRG's refresh coins, SAGA's drawn table slots and ``wire_bits`` are
equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api.runner import build as jax_build
from repro_torch import random as R
from repro_torch.api import RunSpec
from repro_torch.api.runner import build
from repro_torch.convert import key_from_numpy, state_from_numpy, tree_from_numpy
from repro_torch.core.estimators import saga_indices

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TRAJ_TOL = 2e-5
STEPS = 5
METHODS = ("sgd", "sgdm", "csgd", "diana", "mvr", "svrg", "cmfilter", "saga")
# the contract harness's picks: svrg's paper pairing is RFA, saga's
# minibatch of table slots is 8; svrg's p = 0.5 gives both coins in 5
# rounds at this seed
_METHOD_KW = {"svrg": {"aggregator": "rfa", "p": 0.5},
              "saga": {"method_kwargs": {"batch_size": 8}}}


def _spec(method, agg_mode):
    base = dict(method=method, n_workers=5, n_byz=1, attack="ALIE",
                aggregator="cm", bucket_size=2, agg_mode=agg_mode,
                compressor="randk", compressor_kwargs={"ratio": 0.5}, p=0.3,
                lr=0.25, steps=STEPS, seed=3,
                data_kwargs={"dim": 30, "n_samples": 60, "batch_size": 8})
    return JaxRunSpec(**{**base, **_METHOD_KW.get(method, {})})


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _to_numpy(state):
    return {k: _np(v) if isinstance(v, dict) else v for k, v in state.items()}


def _close(got, ref, what):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), what
        for k in ref:
            _close(got[k], ref[k], f"{what}.{k}")
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TRAJ_TOL,
                               atol=TRAJ_TOL, err_msg=what)


def _close_state(tstate, jstate):
    keys = sorted(set(jstate) - {"opt_state", "step"})
    assert sorted(set(tstate) - {"opt_state", "step"}) == keys
    for k in keys:
        _close(tstate[k], jstate[k], k)


def _coin(est, cfg, k_step):
    """The refresh coin of a round of SVRG in both packages."""
    jkeys = dict(zip(est.rng, jax.random.split(k_step, len(est.rng))))
    tkeys = dict(zip(est.rng, R.split(key_from_numpy(k_step), len(est.rng))))
    want = bool(jax.random.bernoulli(jkeys["bern"], cfg.p))
    assert bool(R.bernoulli(tkeys["bern"], cfg.p)) == want
    return want


def _saga_slots(est, cfg, k_step, m):
    """SAGA's (n, b) table slots of a round in both packages."""
    b = min(est.batch_size, m)
    jkeys = dict(zip(est.rng, jax.random.split(k_step, len(est.rng))))
    want = np.stack([np.asarray(jax.random.permutation(
        jax.random.split(jax.random.fold_in(jkeys["grad"], i))[0], m)[:b])
        for i in range(cfg.n_workers)])
    tkeys = dict(zip(est.rng, R.split(key_from_numpy(k_step), len(est.rng))))
    kg = R.fold_in(tkeys["grad"], torch.arange(cfg.n_workers))
    got = saga_indices(R.split(kg, 2)[:, 0], m, b).numpy()
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("agg_mode", ["gspmd", "pallas"])
@pytest.mark.parametrize("method", METHODS)
def test_engine_init_and_steps(method, agg_mode):
    spec = _spec(method, agg_mode)
    jexp = jax_build(spec)
    texp = build(RunSpec.from_dict(spec.to_dict()), device="cpu")
    k_init, k_run = jax.random.split(jax.random.PRNGKey(spec.seed))
    params = jexp.init_params(k_init)
    anchor = jexp.anchor(0)
    jstate = jexp.method.init(params, anchor, k_run)
    tstate = texp.method.init(tree_from_numpy(_np(params)),
                              tree_from_numpy(_np(anchor)),
                              key_from_numpy(k_run))
    _close_state(tstate, jstate)
    if method == "diana":
        assert float(tstate["alpha"]) == float(jstate["alpha"])
    jstep = jax.jit(jexp.method.step)
    coins = []
    for it in range(STEPS):
        k_step, k_batch = jax.random.split(jax.random.fold_in(k_run, it + 1))
        batch = jexp.minibatch(it, k_batch)
        jnew, jm = jstep(jstate, batch, anchor, k_step)
        told = state_from_numpy(_to_numpy(jstate))
        tnew, tm = texp.method.step(
            told, tree_from_numpy(_np(batch)), tree_from_numpy(_np(anchor)),
            key_from_numpy(k_step))
        assert sorted(tm) == sorted(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL)
        if "wire_bits" in jm:
            assert tm["wire_bits"] == float(jm["wire_bits"])
        _close_state(tnew, jnew)
        if method == "svrg":
            coins.append(_coin(texp.method.estimator, texp.cfg, k_step))
            want = told["params"] if coins[-1] else told["snapshot"]
            for k in want:
                assert torch.equal(tnew["snapshot"][k], want[k])
        if method == "saga":
            m = anchor["x"].shape[1]
            slots = _saga_slots(texp.method.estimator, texp.cfg, k_step, m)
            for i in range(texp.cfg.n_workers):
                changed = (tnew["worker_table"]["w"][i]
                           != told["worker_table"]["w"][i]).any(-1)
                assert set(np.flatnonzero(changed.numpy())) == set(slots[i])
        jstate = jnew
    if method == "svrg":
        assert set(coins) == {True, False}, coins
