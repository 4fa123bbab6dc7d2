"""Byz-EF21 with TopK (the fourth slice) against the reference, one engine
step at a time and as whole runs of one spec, on ``agg_mode`` pallas (the
reference's kernels in interpret mode) and gspmd.

At dim 4500 the leaf w is wider than two 2048-column tiles, so the
reference's TopK really runs its Pallas pool kernel (``topk_select``)
and the port its plain pool version. Losses, params, the server estimate
g and every worker's error-feedback state ``worker_g`` agree to 2e-5, the
reference's pallas≡gspmd tolerance; the TopK selections agree exactly
(no flip showed at these seeds and sizes), and the wire bits and the
communication count agree exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import run as jax_run
from repro.api.runner import build as jax_build
from repro_torch.api import RunSpec, run
from repro_torch.api.runner import build
from repro_torch.convert import key_from_numpy, state_from_numpy, tree_from_numpy
from repro_torch.core.byz_vr_marina import ByzVRMarinaConfig
from repro_torch.core import compressors
from repro_torch.core.estimators import get_estimator
from repro_torch.kernels import norm_agg, quantize
from repro_torch.kernels.robust_agg import robust_agg

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TRAJ_TOL = 2e-5
STEPS = 8
SPEC = dict(method="byz_ef21", n_workers=5, n_byz=1, attack="ALIE",
            aggregator="cm", bucket_size=2, compressor="topk",
            compressor_kwargs={"ratio": 0.1}, steps=STEPS,
            data_kwargs={"dim": 4500, "n_samples": 100, "batch_size": 8})


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _close(got, ref):
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL)


@pytest.mark.parametrize("agg_mode", ["pallas", "gspmd"])
def test_engine_init_and_steps(agg_mode):
    """JAX state (worker_g included), anchor and keys carried across
    through convert before every step."""
    spec = JaxRunSpec(**{**SPEC, "agg_mode": agg_mode})
    jexp = jax_build(spec)
    texp = build(RunSpec.from_dict(spec.to_dict()), device="cpu")
    k_init, k_run = jax.random.split(jax.random.PRNGKey(spec.seed))
    params = jexp.init_params(k_init)
    anchor = jexp.anchor(0)
    jstate = jexp.method.init(params, anchor, k_run)
    tstate = texp.method.init(tree_from_numpy(_np(params)),
                              tree_from_numpy(_np(anchor)),
                              key_from_numpy(k_run))
    _close(tstate["g"], jstate["g"])
    _close(tstate["worker_g"], jstate["worker_g"])
    for it in range(4):
        k_step, k_batch = jax.random.split(jax.random.fold_in(k_run, it + 1))
        batch = jexp.minibatch(it, k_batch)
        jnew, jm = jexp.method.step(jstate, batch, anchor, k_step)
        tnew, tm = texp.method.step(
            state_from_numpy({k: _np(v) if isinstance(v, dict) else v
                              for k, v in jstate.items()}),
            tree_from_numpy(_np(batch)), tree_from_numpy(_np(anchor)),
            key_from_numpy(k_step))
        assert "c_k" not in tm                     # EF21 uploads every round
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL)
        assert tm["wire_bits"] == float(jm["wire_bits"])
        for name in ("params", "g", "worker_g"):
            _close(tnew[name], jnew[name])
        jstate = jnew


def _entry_calls(aggregator, agg_mode):
    """Aggregation entry-point calls of a run of STEPS rounds: under
    pallas each of the 1 + STEPS aggregations runs on the leaves b and w
    apart (w is wider than the small-leaf packing), dense at init, then
    on the wire (TopK) or dense (identity); RFA makes 8 Weiszfeld passes
    and a weighted sum per leaf, Krum a Gram and a weighted sum."""
    calls = dict.fromkeys(("robust_agg", "pair_gram", "rfa_iter",
                           "weighted_sum"), 0)
    if agg_mode == "pallas":
        per_leaf = {"cm": {"robust_agg": 1},
                    "rfa": {"rfa_iter": 8, "weighted_sum": 1},
                    "krum": {"pair_gram": 1, "weighted_sum": 1}}[aggregator]
        calls.update({k: 2 * (1 + STEPS) * v for k, v in per_leaf.items()})
    return calls


@pytest.mark.parametrize("aggregator, compressor, agg_mode", [
    ("cm", "topk", "pallas"), ("cm", "topk", "gspmd"),
    ("rfa", "topk", "pallas"), ("krum", "topk", "pallas"),
    ("cm", "identity", "pallas")])
def test_run_matches_reference(aggregator, compressor, agg_mode):
    """Whole runs; every round of TopK on the wire selects on both
    leaves."""
    jspec = JaxRunSpec(**{**SPEC, "agg_mode": agg_mode,
                          "aggregator": aggregator, "compressor": compressor,
                          "compressor_kwargs": ({"ratio": 0.1}
                                                if compressor == "topk"
                                                else {})})
    ref = jax_run(jspec, log_every=1)
    fns = {"robust_agg": robust_agg, "pair_gram": norm_agg.pair_gram,
           "rfa_iter": norm_agg.rfa_iter,
           "weighted_sum": norm_agg.weighted_sum,
           "topk_select": quantize.topk_select}
    for fn in fns.values():
        fn.calls = fn.launches = 0
    got = run(RunSpec.from_json(jspec.to_json()), device="cpu", log_every=1)
    assert got.comm_bits == ref.comm_bits
    assert [h["wire_bits"] for h in got.history] == \
        [h["wire_bits"] for h in ref.history]
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in ref.history],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    _close(got.params, ref.params)
    _close(got.state["worker_g"], ref.state["worker_g"])
    on_wire = compressor == "topk" and agg_mode == "pallas"
    assert {k: fn.calls for k, fn in fns.items()} == {
        **_entry_calls(aggregator, agg_mode),
        "topk_select": 2 * STEPS if on_wire else 0}
    assert all(fn.launches == 0 for fn in fns.values())    # plain on CPU


@pytest.mark.parametrize("compressor", ["randk", "dither", "int8"])
def test_spec_refuses_a_compressor_without_a_contraction_bound(compressor):
    spec = {**SPEC, "agg_mode": "pallas", "compressor": compressor,
            "compressor_kwargs": {}}
    with pytest.raises(ValueError, match="contractive") as ref_err:
        JaxRunSpec(**spec)
    with pytest.raises(ValueError, match="contractive") as err:
        RunSpec(**spec)
    assert str(err.value) == str(ref_err.value)


def test_factory_refuses_randk():
    cfg = ByzVRMarinaConfig(n_workers=5, n_byz=1,
                            compressor=compressors.rand_k(0.1))
    with pytest.raises(ValueError, match="contractive compressor"):
        get_estimator("byz_ef21", cfg)
    cfg = ByzVRMarinaConfig(n_workers=5, n_byz=1,
                            compressor=compressors.top_k(0.1))
    assert get_estimator("byz_ef21", cfg).name == "byz_ef21"
