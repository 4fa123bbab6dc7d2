"""Tracing (``RunSpec.trace``, ``repro_torch.obs.trace``) against the
reference and against the port's own untraced runs.

* The telemetry twin is free on the trajectory: a traced run ends with the
  untraced run's losses and parameters bit for bit, and calls the kernel
  entry points (their plain versions here) exactly as often.
* The trace fields agree with ``repro.api.run(spec(trace=True)).traces``:
  masks and ``krum_selected`` exactly, the float fields to 2e-5 of their
  largest entry. A distance is the difference of two vectors that the
  port and the reference compute in different float32 orders (ROADMAP
  queue 3: the logits), so on a full round, where every worker sends the
  same anchor gradient, the distances are rounding noise; they are held
  to 2e-5 of the larger of their largest entry and the aggregate's norm
  (its square for Krum's scores).
* cm's and tm's bucket weights (and the influence built on them) count
  rank positions, and on a RandK round most coordinates tie exactly (every
  row carries g^k there): the padded bucket's value then lands on either
  side of the tie by an ulp of g^k, which the two trajectories do not
  share. Those fields are held instead on identical inputs, one message
  phase in each package, where they agree to 2e-5 (the ranks exactly).
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import run as jax_run
from repro.core import tree_utils as jax_tu
from repro.core import wire as jax_wire
from repro.obs import trace as jax_trace
from repro_torch.api import RunSpec, run
from repro_torch.convert import key_from_numpy
from repro_torch.core import wire
from repro_torch.kernels import norm_agg
from repro_torch.kernels.robust_agg import robust_agg
from repro_torch.obs import trace

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TOL = 2e-5
STEPS = 4
BASE = dict(n_workers=5, n_byz=1, attack="ALIE", bucket_size=2,
            compressor="randk", compressor_kwargs={"ratio": 0.1}, p=0.5,
            steps=STEPS, data_kwargs={"dim": 12, "n_samples": 64,
                                      "batch_size": 8})
CHAOS = dict(fault_guard=True, faults={"seed": 0, "faults": [
    {"kind": "nan_grad", "prob": 0.5, "workers": [4]},
    {"kind": "corrupt_wire", "prob": 0.5, "workers": [3]}]})
# 72 workers, unbucketed: more rows than the fused kernels hold, so the
# blocked drivers' info (Krum's scores and pick, RFA's weights and residual)
GIANT = dict(n_workers=72, n_byz=8, bucket_size=1, data_kwargs={
    "dim": 4, "n_samples": 40, "batch_size": 4})
MASKS = ("byz_mask", "fault_mask", "guard_valid", "sampled_mask")
RANKED = ("bucket_weights", "influence")
FNS = {"robust_agg": robust_agg, "pair_gram": norm_agg.pair_gram,
       "rfa_iter": norm_agg.rfa_iter, "weighted_sum": norm_agg.weighted_sum,
       "pair_gram_blocked": norm_agg.pair_gram_blocked,
       "sqdist_to_blocked": norm_agg.sqdist_to_blocked,
       "weighted_sum_blocked": norm_agg.weighted_sum_blocked}


def _scale(field, vals, g_norm):
    top = float(np.max(np.abs(vals))) if vals.size else 0.0
    if field in ("dist_to_agg", "rfa_residual"):
        return max(top, g_norm)
    if field == "krum_scores":
        return max(top, g_norm ** 2)
    return top


def assert_trace_close(got, ref, g_norm, ranked=True):
    """One host trace against another (module docstring's tolerances);
    ``ranked`` False leaves out cm / tm's rank-count fields."""
    assert sorted(got) == sorted(ref)
    assert got["rule"] == ref["rule"]
    for k in ref:
        if k == "rule":
            continue
        if k in MASKS or k == "krum_selected":
            assert got[k] == ref[k], k
            continue
        if not ranked and ref["rule"] in ("cm", "tm") and k in RANKED:
            continue
        a = np.atleast_1d(np.asarray(got[k], np.float64))
        b = np.atleast_1d(np.asarray(ref[k], np.float64))
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=k)
        np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=k)
        err = float(np.max(np.abs(a[fin] - b[fin]), initial=0.0))
        assert err <= TOL * _scale(k, b[fin], g_norm), (k, err, a, b)


def _counted_run(spec):
    for fn in FNS.values():
        fn.calls = 0
    res = run(spec, device="cpu", log_every=1)
    return res, {k: fn.calls for k, fn in FNS.items()}


RUN_SPECS = {f"{mode} {rule}": dict(BASE, agg_mode=mode, aggregator=rule)
             for mode in ("gspmd", "pallas") for rule in ("cm", "rfa", "krum")}
RUN_SPECS.update({
    # the guard's masks here; the masked kernels' info under the cohort
    "gspmd krum chaos": dict(BASE, agg_mode="gspmd", aggregator="krum",
                             **CHAOS),
    "pallas krum participation": dict(BASE, agg_mode="pallas",
                                      aggregator="krum", participation=0.8),
    "pallas cm chaos": dict(BASE, agg_mode="pallas", aggregator="cm",
                            **CHAOS),
    "pallas krum n=72": dict(BASE, agg_mode="pallas", aggregator="krum",
                             **GIANT),
    "pallas rfa n=72": dict(BASE, agg_mode="pallas", aggregator="rfa",
                            **GIANT),
})


@pytest.fixture(scope="module")
def port_runs():
    """Each spec's traced and untraced port runs and their entry calls."""
    out = {}
    for tag, spec in RUN_SPECS.items():
        traced = _counted_run(RunSpec(**spec, trace=True))
        plain = _counted_run(RunSpec(**spec))
        out[tag] = (traced, plain)
    return out


@pytest.mark.parametrize("tag", sorted(RUN_SPECS))
def test_traced_run_equals_untraced_bit_for_bit(port_runs, tag):
    (traced, t_calls), (plain, p_calls) = port_runs[tag]
    assert t_calls == p_calls                      # the same driver calls
    assert len(traced.traces) == STEPS and not plain.traces
    assert [h["loss"] for h in traced.history] == \
        [h["loss"] for h in plain.history]
    for k in ("params", "g"):
        for name in plain.state[k]:
            assert torch.equal(traced.state[k][name], plain.state[k][name])
    extra = set(traced.history[0]) - set(plain.history[0])
    assert {"detect_precision", "detect_recall", "byz_leakage",
            "n_filtered"} <= extra


@pytest.mark.parametrize("tag", sorted(RUN_SPECS))
def test_trace_fields_match_reference_run(port_runs, tag):
    ref = jax_run(JaxRunSpec(**RUN_SPECS[tag], trace=True), log_every=1)
    (got, _), _ = port_runs[tag]
    assert len(got.traces) == len(ref.traces) == STEPS
    for t, (a, b, h) in enumerate(zip(got.traces, ref.traces, ref.history)):
        assert_trace_close(a, b, h["g_norm"], ranked=False)
    if "chaos" in tag:
        assert any(not all(t["guard_valid"]) for t in got.traces)
        assert all("fault_recall" in h for h in got.history)
    if "participation" in tag:
        assert all(sum(t["sampled_mask"]) == 4 for t in got.traces)
    if "krum" in tag:
        for a, b in zip(got.history, ref.history):
            for k in ("detect_precision", "detect_recall", "n_filtered"):
                assert a[k] == b[k], k
        assert (got.detection_summary().keys()
                == ref.detection_summary().keys())


def _phase_inputs(n=5, d=24, seed=0):
    """A RandK-round stack: every row g^k plus a sparse per-worker delta,
    so most coordinates tie; the two packages' keys."""
    rng = np.random.default_rng(seed)
    g = {"b": rng.standard_normal(1).astype(np.float32),
         "w": rng.standard_normal(d).astype(np.float32)}
    delta = {k: (rng.standard_normal((n,) + v.shape)
                 * (rng.random((n,) + v.shape) < 0.2)).astype(np.float32)
             for k, v in g.items()}
    ka, kg = jax.random.split(jax.random.PRNGKey(seed + 1))
    return g, delta, ka, kg


@pytest.mark.parametrize("mode,rule,on_wire", [
    ("gspmd", "tm", False), ("pallas", "cm", False), ("pallas", "cm", True)])
def test_trace_on_identical_inputs(mode, rule, on_wire):
    """One message phase in each package on the same candidates and keys
    (the reference under ``jax.jit``): every field, ranks included."""
    spec = dict(BASE, agg_mode=mode, aggregator=rule, trace=True)
    jcfg = JaxRunSpec(**spec).build_config()
    cfg = RunSpec(**spec).build_config()
    g, delta, ka, kg = _phase_inputs()
    n = 5
    if on_wire:
        qk = jax_tu.per_worker_keys(jax.random.PRNGKey(9), n)
        jc = jax_wire.pack_candidates(jcfg.compressor, qk, delta, base=g,
                                      base_shared=True)
        tc = wire.pack_candidates(
            cfg.compressor, key_from_numpy(qk),
            {k: torch.tensor(v) for k, v in delta.items()},
            base={k: torch.tensor(v) for k, v in g.items()},
            base_shared=True)
        assert isinstance(tc, wire.WireCandidates)
    else:
        jc = {k: g[k][None] + delta[k] for k in g}
        tc = {k: torch.tensor(v) for k, v in jc.items()}
    jagg, jrt = jax.jit(lambda c: jax_trace.traced_message_phase(
        jcfg, ka, kg, c))(jc)
    agg, rt = trace.traced_message_phase(cfg, key_from_numpy(ka),
                                         key_from_numpy(kg), tc)
    for k in g:
        np.testing.assert_allclose(agg[k].numpy(), jagg[k], rtol=TOL,
                                   atol=TOL)
    g_norm = float(np.sqrt(sum(np.sum(np.square(v)) for v in
                               jax.tree.leaves(jagg))))
    assert_trace_close(trace.to_host(rt), jax_trace.to_host(jrt), g_norm)
    if rule in ("cm", "tm"):
        np.testing.assert_array_equal(trace.to_host(rt)["bucket_weights"],
                                      jax_trace.to_host(jrt)["bucket_weights"])
