"""The port's fault layer against the reference's ``repro.faults``.

Plans round-trip through JSON exactly and fail closed on bad input, as
the reference's; the injection draws (``fault_masks``,
``inject_candidates``, ``inject_wire`` with its bit flips) and the guard's
masks (``finite_row_mask``, ``payload_valid``, ``masked_bucket_matrix``)
are bit for bit the reference's on the same numpy inputs and keys; and a
whole chaos run (the fault guard on, NaN gradients and corrupted wire
payloads on worker 4) keeps the reference's c_k coins, stays finite and
follows its losses to 2e-5, the reference's pallas≡gspmd tolerance, with
cm, RFA and Krum.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import run as jax_run
from repro.core import wire as jwire
from repro.faults import guard as jguard
from repro.faults import inject as jinject
from repro.faults.plan import FaultPlan as JaxFaultPlan
from repro_torch.api import RunSpec, run
from repro_torch.api.runner import build
from repro_torch.convert import key_from_numpy, tree_from_numpy
from repro_torch.core import wire as twire
from repro_torch.faults import guard, inject
from repro_torch.faults.plan import FaultPlan, FaultSpec, as_plan

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TRAJ_TOL = 2e-5
PLANS = [
    {"seed": 7, "faults": [{"kind": "nan_grad", "prob": 0.5,
                            "workers": [1, 3]},
                           {"kind": "corrupt_wire"},
                           {"kind": "crash", "prob": 0.1}]},
    {"seed": 0, "faults": [{"kind": "nan_grad", "prob": 0.2,
                            "workers": [4]},
                           {"kind": "corrupt_wire", "prob": 0.2,
                            "workers": [4]}]},
    {"seed": 3, "faults": [{"kind": "inf_blowup", "prob": 0.3},
                           {"kind": "stale_replay", "workers": [6, 40]},
                           {"kind": "nan_grad", "prob": 0.0}]},
]
CHAOS_SPEC = dict(
    n_workers=5, n_byz=1, attack="ALIE", aggregator="cm", bucket_size=2,
    agg_mode="pallas", compressor="randk", compressor_kwargs={"ratio": 0.1},
    p=0.1, lr=0.5, steps=20, fault_guard=True,
    faults={"seed": 0, "faults": [
        {"kind": "nan_grad", "prob": 0.2, "workers": [4]},
        {"kind": "corrupt_wire", "prob": 0.2, "workers": [4]}]},
    data_kwargs={"dim": 123})


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", PLANS)
def test_plan_json_round_trip_matches_reference(plan):
    got = FaultPlan.from_dict(plan)
    assert FaultPlan.from_json(got.to_json()) == got
    assert got.to_json() == JaxFaultPlan.from_dict(plan).to_json()
    assert FaultPlan.from_dict(json.loads(got.to_json())) == got
    for n in (1, 5, 8, 64):
        assert got.worst_case_faulty(n) == JaxFaultPlan.from_dict(
            plan).worst_case_faulty(n)


def test_plan_shorthand_and_coercion():
    assert as_plan({"faults": ["stale_replay"]}).faults[0].kind == \
        "stale_replay"
    assert as_plan(None) is None and as_plan({}) is None
    plan = FaultPlan.from_dict(PLANS[0])
    assert as_plan(plan) is plan


@pytest.mark.parametrize("bad, err, match", [
    (lambda: FaultSpec("nan_gradd"), ValueError, "did you mean 'nan_grad'"),
    (lambda: FaultSpec("crash", prob=1.5), ValueError, "prob"),
    (lambda: FaultSpec("crash", workers=(-1,)), ValueError, "workers"),
    (lambda: FaultPlan.from_dict({"seed": 0, "fault": []}), ValueError,
     "unknown FaultPlan keys"),
    (lambda: FaultPlan.from_dict({"faults": [{"kind": "crash", "probs": 1}]}),
     ValueError, "unknown FaultSpec keys"),
    (lambda: FaultPlan.from_dict([]), TypeError, "dict expected"),
])
def test_plan_errors(bad, err, match):
    with pytest.raises(err, match=match):
        bad()


# ---------------------------------------------------------------------------
# injection draws, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_masks_match_reference(plan, seed):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
    tkey = key_from_numpy(jkey)
    jplan, tplan = JaxFaultPlan.from_dict(plan), FaultPlan.from_dict(plan)
    for n in (5, 64):
        ref = jinject.fault_masks(jplan, jkey, n)
        got = inject.fault_masks(tplan, tkey, n)
        assert sorted(got) == sorted(ref)
        for kind in ref:
            np.testing.assert_array_equal(got[kind].numpy(),
                                          np.asarray(ref[kind]))
        np.testing.assert_array_equal(
            inject.injected_mask(tplan, tkey, n).numpy(),
            np.asarray(jinject.injected_mask(jplan, jkey, n)))
    np.testing.assert_array_equal(
        inject.fault_key(tplan, tkey, 3).numpy(),
        np.asarray(jinject.fault_key(jplan, jkey, 3)).astype(np.int64))


def _cand(n, seed):
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal(n).astype(np.float32),
            "w": rng.standard_normal((n, 7, 3)).astype(np.float32)}


@pytest.mark.parametrize("plan", PLANS)
def test_inject_candidates_matches_reference(plan):
    cand = _cand(10, 1)
    jkey = jax.random.PRNGKey(5)
    ref = jinject.inject_candidates(JaxFaultPlan.from_dict(plan), jkey,
                                    {k: jnp.asarray(v)
                                     for k, v in cand.items()})
    got = inject.inject_candidates(FaultPlan.from_dict(plan),
                                   key_from_numpy(jkey),
                                   tree_from_numpy(cand))
    for k in cand:
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(ref[k]))


def _wire_pair(n, d, k, seed):
    """One leaf's sparse payload with a shared base, in both packages'
    ``WireCandidates``."""
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([rng.permutation(d)[:k] for _ in range(n)]),
                  axis=1).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    base = rng.standard_normal((1, d)).astype(np.float32)
    jwc = jwire.WireCandidates(
        fmt="sparse", n=n,
        payloads=({"vals": jnp.asarray(vals), "idx": jnp.asarray(idx)},),
        base=(jnp.asarray(base),),
        treedef=jax.tree.structure({"w": 0}), shapes=((d,),),
        dtypes=(jnp.float32,), src_dtypes=(jnp.float32,))
    twc = twire.WireCandidates(
        fmt="sparse", n=n,
        payloads=({"vals": torch.as_tensor(vals),
                   "idx": torch.as_tensor(idx)},),
        base=(torch.as_tensor(base),), names=("w",), shapes=((d,),),
        dtypes=(torch.float32,), src_dtypes=(torch.float32,))
    return jwc, twc


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("seed", [0, 4])
def test_inject_wire_matches_reference(plan, seed):
    """Fills and bit flips, the float payload through its int32 carrier,
    equal bit for bit; then the decode guard and the reconstruction (a
    garbled index is dropped, as the reference's scatter drops it)."""
    jwc, twc = _wire_pair(8, 300, 30, seed)
    jkey = jax.random.PRNGKey(seed + 11)
    ref = jinject.inject_wire(JaxFaultPlan.from_dict(plan), jkey, jwc)
    got = inject.inject_wire(FaultPlan.from_dict(plan), key_from_numpy(jkey),
                             twc)
    for name in ("vals", "idx"):
        np.testing.assert_array_equal(_bits(got.payloads[0][name].numpy()),
                                      _bits(ref.payloads[0][name]))
    np.testing.assert_array_equal(guard.payload_valid(got).numpy(),
                                  np.asarray(jguard.payload_valid(ref)))
    np.testing.assert_array_equal(
        _bits(twire.reconstruct(got)["w"].numpy()),
        _bits(jwire.reconstruct(ref)["w"]))


# ---------------------------------------------------------------------------
# guard masks
# ---------------------------------------------------------------------------

def test_finite_row_mask_matches_reference():
    cand = _cand(9, 2)
    cand["w"][2, 1, 1] = np.nan
    cand["w"][5, 0, 2] = np.inf
    cand["b"][7] = -np.inf
    ref = jguard.finite_row_mask({k: jnp.asarray(v) for k, v in cand.items()})
    got = guard.finite_row_mask(tree_from_numpy(cand))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.tolist() == [i not in (2, 5, 7) for i in range(9)]


@pytest.mark.parametrize("n, s", [(5, 2), (7, 3), (8, 2), (33, 2), (130, 2)])
def test_masked_bucket_matrix_matches_reference(n, s):
    rng = np.random.default_rng(n + s)
    perm = rng.permutation(n)
    valid = rng.random(n) > 0.4
    wj, bj = jguard.masked_bucket_matrix(jnp.asarray(perm), n, s,
                                         jnp.asarray(valid))
    wt, bt = guard.masked_bucket_matrix(torch.as_tensor(perm), n, s,
                                        torch.as_tensor(valid))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    wj, bj = jguard.identity_bucket_matrix(n, jnp.asarray(valid))
    wt, bt = guard.identity_bucket_matrix(n, torch.as_tensor(valid))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    x = rng.standard_normal((n, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        guard.masked_sort_fill(torch.as_tensor(x),
                               torch.as_tensor(valid)).numpy(),
        np.asarray(jguard.masked_sort_fill(jnp.asarray(x),
                                           jnp.asarray(valid))))


# ---------------------------------------------------------------------------
# the spec and whole chaos runs
# ---------------------------------------------------------------------------

def test_spec_builds_the_fault_layer():
    spec = RunSpec(**CHAOS_SPEC)
    cfg = build(spec, device="cpu").cfg
    assert cfg.fault_guard and cfg.fault_plan == FaultPlan.from_dict(
        CHAOS_SPEC["faults"])
    assert cfg.n_active is None
    with pytest.raises(ValueError, match="unknown fault kind"):
        RunSpec(**{**CHAOS_SPEC, "faults": {"faults": ["nan_gradd"]}})


def test_spec_warns_where_the_reference_warns():
    """Faults on 2 of 5 workers on top of one byzantine: past δ = 1/2."""
    faults = {"faults": [{"kind": "nan_grad", "workers": [3, 4]}]}
    for cls in (RunSpec, JaxRunSpec):
        with pytest.warns(UserWarning, match="fault plan can hit 2"):
            cls(**{**CHAOS_SPEC, "faults": faults})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        RunSpec(**CHAOS_SPEC)


@pytest.mark.parametrize("aggregator", ["cm", "rfa", "krum"])
def test_chaos_run_matches_reference(aggregator):
    jspec = JaxRunSpec(**{**CHAOS_SPEC, "aggregator": aggregator})
    ref = jax_run(jspec, log_every=1)
    got = run(RunSpec.from_json(jspec.to_json()), device="cpu", log_every=1)
    ck = [int(h["c_k"]) for h in got.history]
    assert ck == [int(h["c_k"]) for h in ref.history]
    assert set(ck) == {0, 1}
    losses = np.array([h["loss"] for h in got.history])
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, [h["loss"] for h in ref.history],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for k, v in got.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref.params[k]),
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL)
