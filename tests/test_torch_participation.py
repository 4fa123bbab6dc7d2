"""Partial participation in the port against the reference.

The sampled cohort (``engine.sampled_worker_mask``, a permutation drawn
from the step key folded with its own salt) is bit for bit the
reference's for every round of a run; non-sampled workers' Byz-EF21
state carries forward untouched (``carry_unsampled_state``), as the
reference's; and whole runs at ``participation=0.8`` with the fault guard
and the chaos plan (cm, RFA, Krum), without them (cm), at 130 workers
(the giant-n tier's masked bucketing and blocked drivers) and with
Byz-EF21 keep the reference's c_k coins and follow its losses to 2e-5,
the reference's pallas≡gspmd tolerance.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import run as jax_run
from repro.api.runner import build as jax_build
from repro.core import engine as jengine
from repro_torch import random as R
from repro_torch.api import RunSpec, run
from repro_torch.api.runner import build
from repro_torch.convert import key_from_numpy, state_from_numpy, \
    tree_from_numpy
from repro_torch.core import engine

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TRAJ_TOL = 2e-5
CHAOS = dict(
    n_workers=5, n_byz=1, attack="ALIE", aggregator="cm", bucket_size=2,
    agg_mode="pallas", compressor="randk", compressor_kwargs={"ratio": 0.1},
    p=0.1, lr=0.5, steps=20, participation=0.8, fault_guard=True,
    faults={"seed": 0, "faults": [
        {"kind": "nan_grad", "prob": 0.2, "workers": [4]},
        {"kind": "corrupt_wire", "prob": 0.2, "workers": [4]}]},
    data_kwargs={"dim": 123})
GIANT = dict(n_workers=130, n_byz=13, participation=0.75, steps=6,
             data_kwargs={"dim": 40, "n_samples": 1300, "batch_size": 8})


def _cohorts(spec, steps):
    """The sampled masks of a run's rounds, from its own key schedule, in
    both packages."""
    jcfg, tcfg = jax_build(spec).cfg, build(RunSpec.from_json(
        spec.to_json()), device="cpu").cfg
    _, k_run = jax.random.split(jax.random.PRNGKey(spec.seed))
    out = []
    for it in range(steps):
        k_step, _ = jax.random.split(jax.random.fold_in(k_run, it + 1))
        ref = np.asarray(jengine.sampled_worker_mask(jcfg, k_step))
        got = engine.sampled_worker_mask(tcfg, key_from_numpy(k_step))
        np.testing.assert_array_equal(got.numpy(), ref)
        out.append(ref)
    return out


@pytest.mark.parametrize("n, part", [(5, 0.8), (16, 5), (130, 0.75),
                                     (256, 0.1)])
def test_sampled_worker_mask_matches_reference(n, part):
    spec = JaxRunSpec(**{**CHAOS, "n_workers": n, "n_byz": 1,
                         "participation": part, "faults": {},
                         "fault_guard": False})
    masks = _cohorts(spec, 6)
    n_active = spec.resolved_participation()
    assert all(m.sum() == n_active for m in masks)
    assert len({m.tobytes() for m in masks}) > 1


def test_full_participation_samples_nothing():
    cfg = build(RunSpec(**{**CHAOS, "participation": 1.0}), device="cpu").cfg
    assert cfg.n_active is None
    assert engine.sampled_worker_mask(cfg, R.PRNGKey(0)) is None


def test_carry_unsampled_state_on_ef21_worker_g():
    """One Byz-EF21 step at participation 0.5: the port's new state
    (including the frozen rows of worker_g) equals the reference's."""
    spec = JaxRunSpec(**{**CHAOS, "method": "byz_ef21", "compressor": "topk",
                         "n_workers": 8, "participation": 0.5, "faults": {},
                         "fault_guard": False})
    jexp = jax_build(spec)
    texp = build(RunSpec.from_json(spec.to_json()), device="cpu")
    k_init, k_run = jax.random.split(jax.random.PRNGKey(spec.seed))
    params = jexp.init_params(k_init)
    anchor = jexp.anchor(0)
    jstate = jexp.method.init(params, anchor, k_run)
    k_step, k_batch = jax.random.split(jax.random.fold_in(k_run, 1))
    batch = jexp.minibatch(0, k_batch)
    jnew, _ = jax.jit(jexp.method.step)(jstate, batch, anchor, k_step)
    tnew, _ = texp.method.step(
        state_from_numpy(jax.tree.map(np.asarray, jstate)),
        tree_from_numpy(jax.tree.map(np.asarray, batch)),
        tree_from_numpy(jax.tree.map(np.asarray, anchor)),
        key_from_numpy(k_step))
    sampled = np.asarray(jengine.sampled_worker_mask(jexp.cfg, k_step))
    assert sampled.sum() == 4
    for k in ("b", "w"):
        old = np.asarray(jstate["worker_g"][k])
        got = tnew["worker_g"][k].numpy()
        np.testing.assert_array_equal(got[~sampled], old[~sampled])
        assert (got[sampled] != old[sampled]).any()
        np.testing.assert_allclose(got, np.asarray(jnew["worker_g"][k]),
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL)


def _same_run(spec, steps):
    ref = jax_run(spec, log_every=1)
    got = run(RunSpec.from_json(spec.to_json()), device="cpu", log_every=1)
    assert ([int(h.get("c_k", 1)) for h in got.history]
            == [int(h.get("c_k", 1)) for h in ref.history])
    losses = np.array([h["loss"] for h in got.history])
    assert len(losses) == steps and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, [h["loss"] for h in ref.history],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for k, v in got.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref.params[k]),
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL)
    return got


@pytest.mark.parametrize("aggregator", ["cm", "rfa", "krum"])
def test_chaos_run_with_participation_matches_reference(aggregator):
    spec = JaxRunSpec(**{**CHAOS, "aggregator": aggregator})
    _cohorts(spec, spec.steps)
    got = _same_run(spec, spec.steps)
    assert {int(h["c_k"]) for h in got.history} == {0, 1}


def test_participation_run_matches_reference():
    """Participation alone: the cohort rides as ``valid`` into the fused
    attack and the masked kernels."""
    _same_run(JaxRunSpec(**{**CHAOS, "faults": {}, "fault_guard": False}),
              CHAOS["steps"])


@pytest.mark.parametrize("aggregator", ["rfa", "krum"])
def test_giant_n_participation_matches_reference(aggregator):
    """130 workers, 98 sampled: m = 65 bucket rows of the masked operator,
    some invalid, so ``bvalid`` reaches the blocked drivers."""
    spec = JaxRunSpec(**{**CHAOS, **GIANT, "aggregator": aggregator})
    _same_run(spec, GIANT["steps"])


def test_ef21_participation_matches_reference():
    spec = JaxRunSpec(**{**CHAOS, "method": "byz_ef21", "compressor": "topk",
                         "steps": 8})
    _same_run(spec, 8)


@pytest.mark.parametrize("agg_mode", ["gspmd", "pallas"])
def test_comm_bits_scale_with_participation(agg_mode):
    """Only the sampled cohort uploads: each round is billed at n_active /
    n_workers of its bits, as the reference's runner bills it."""
    spec = JaxRunSpec(**{**CHAOS, "faults": {}, "fault_guard": False,
                         "agg_mode": agg_mode, "steps": 8})
    ref = jax_run(spec, log_every=1)
    got = run(RunSpec.from_json(spec.to_json()), device="cpu", log_every=1)
    assert got.comm_bits == ref.comm_bits
    assert ([h["comm_bits"] for h in got.history]
            == [h["comm_bits"] for h in ref.history])


def test_spec_checks_the_sampled_cohort():
    """The reference's checks: participation needs a masked backend, and
    a cohort that can be majority-byzantine warns."""
    base = {**CHAOS, "faults": {}, "fault_guard": False, "n_workers": 16,
            "n_byz": 2}
    for cls in (RunSpec, JaxRunSpec):
        with pytest.warns(UserWarning, match="active"):
            cls(**{**base, "participation": 4})
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            cls(**{**base, "participation": 12})
        with pytest.raises(ValueError, match="participation"):
            cls(**{**base, "participation": 0.5, "agg_mode": "all_to_all"})
    cfg = build(RunSpec(**{**base, "participation": 12}), device="cpu").cfg
    assert cfg.n_active == 12 and cfg.active_count() == 12
