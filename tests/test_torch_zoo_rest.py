"""The rest of the method zoo against the reference: the step sizes and
rates of ``core/theory.py``, the dense ``dither`` and ``natural``
compressors, importance sampling (``random.choice`` with ``p`` and
``LogRegData.sample_batches_importance``) and sparse-support MARINA.

The theory functions, the compressors (under ``jax.jit``, as the
reference's step compiles them), the cumulative sum and the importance
draws equal the reference's bit for bit; whole runs agree to 2e-5, the
reference's pallas≡gspmd tolerance, with c_k and the communication count
equal.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import run as jax_run
from repro.core import compressors as jax_compressors
from repro.core import theory as jax_theory
from repro.data import make_logreg_data as jax_make_data
from repro_torch import random as R
from repro_torch.api import RunSpec, run
from repro_torch.api.runner import build
from repro_torch.convert import key_from_numpy
from repro_torch.core import compressors, theory
from repro_torch.data import LogRegData

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TRAJ_TOL = 2e-5
STEPS = 4
SPARSE = dict(agg_mode="sparse_support", compressor="randk",
              compressor_kwargs={"ratio": 0.1, "common_randomness": True},
              p=0.5)


def _bits_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    same = (got.view(np.uint32) == ref.view(np.uint32)) | (
        np.isnan(got) & np.isnan(ref))
    assert same.all(), (got[~same][:5], ref[~same][:5])


# -- core/theory.py ---------------------------------------------------------

_PC = [dict(L=1.5), dict(L=2.0, L_pm=0.7, calL_pm=3.1, zeta_sq=0.2, mu=0.01,
                         m=400, d=30),
       dict(L=12.3, calL_pm=25.4, mu=0.02, m=32561, d=123)]
_GRID = [dict(p=p, b=b, G=G, delta=delta, c=c, omega=omega)
         for p, b, G, delta, c, omega in [
             (0.1, 32, 5, 0.2, 6.0, 9.0), (1.0, 1, 1, 0.0, 0.0, 0.0),
             (0.05, 8, 3, 0.4, 6.0, 0.125), (0.5, 16, 64, 0.25, 3.0, 30.0)]]


def test_theory_step_sizes_and_rates_equal_the_reference():
    assert theory.AGG_CONSTANTS == jax_theory.AGG_CONSTANTS
    for kw in _PC:
        pc, jpc = theory.ProblemConstants(**kw), jax_theory.ProblemConstants(
            **kw)
        assert dataclasses.astuple(pc) == dataclasses.astuple(jpc)
        for g in _GRID:
            for fn in ("marina_A", "step_size", "communication_rounds_nc"):
                extra = ({"eps_sq": 1e-3, "delta0": 0.7}
                         if fn.startswith("comm") else {})
                assert (getattr(theory, fn)(pc, **g, **extra)
                        == getattr(jax_theory, fn)(jpc, **g, **extra)), fn
            assert (theory.step_size(pc, **g, pl=True)
                    == jax_theory.step_size(jpc, **g, pl=True))
            if kw.get("mu"):
                assert (theory.communication_rounds_pl(pc, eps=1e-4,
                                                       delta0=0.7, **g)
                        == jax_theory.communication_rounds_pl(
                            jpc, eps=1e-4, delta0=0.7, **g))
        for dc in (0.0, 0.5, 0.99):
            for byz in (0.0, 0.2):
                assert (theory.ef21_step_size(pc, delta_c=dc, byz_delta=byz)
                        == jax_theory.ef21_step_size(jpc, delta_c=dc,
                                                     byz_delta=byz))
                assert (theory.ef21_rounds_nc(pc, eps_sq=1e-3, delta0=0.7,
                                              delta_c=dc, byz_delta=byz)
                        == jax_theory.ef21_rounds_nc(
                            jpc, eps_sq=1e-3, delta0=0.7, delta_c=dc,
                            byz_delta=byz))
        with pytest.raises(ValueError, match="contractive"):
            theory.ef21_step_size(pc, delta_c=1.0)
    for b, m, omega in [(32, 400, 9.0), (1, 10, 0.0), (8, 6512, 0.125)]:
        assert (theory.recommended_p(b=b, m=m, omega=omega)
                == jax_theory.recommended_p(b=b, m=m, omega=omega))
    for mu in (None, 0.0, 0.02):
        assert (theory.error_floor(delta=0.2, c=6.0, p=0.1, zeta_sq=0.3,
                                   mu=mu)
                == jax_theory.error_floor(delta=0.2, c=6.0, p=0.1,
                                          zeta_sq=0.3, mu=mu))


@pytest.mark.parametrize("name,kw", [
    ("identity", {}), ("randk", {"ratio": 0.1}), ("topk", {"ratio": 0.25}),
    ("dither", {}), ("dither", {"levels": 4}), ("natural", {}), ("sign", {}),
    ("int8", {}), ("bf16", {})])
def test_contraction_bounds_and_accounting_equal_the_reference(name, kw):
    comp = compressors.get_compressor(name, **kw)
    ref = jax_compressors.get_compressor(name, **kw)
    assert comp.name == ref.name
    assert comp.fallback_only == ref.fallback_only
    assert comp.wire_format == ref.wire_format
    dims = [1, 30, 123, 4096, 5000]
    for d in dims:
        assert (theory.contractive_delta(comp, d)
                == jax_theory.contractive_delta(ref, d))
        assert comp.bits_per_vector(d) == ref.bits_per_vector(d)
        ow, rw = comp.omega(d), ref.omega(d)
        assert ow == rw or (math.isnan(ow) and math.isnan(rw))
        assert comp.density_fn(d) == ref.density_fn(d)
    assert (theory.tree_contractive_delta(comp, dims)
            == jax_theory.tree_contractive_delta(ref, dims))


@pytest.mark.parametrize("n_samples,dim", [(400, 30), (6512, 123)])
def test_logreg_constants_and_importance_weights_bit_for_bit(n_samples, dim):
    data = jax_make_data(jax.random.PRNGKey(0), n_samples=n_samples,
                         dim=dim, n_workers=5)
    feats = torch.tensor(np.asarray(data.features))
    ref = jax_theory.logreg_constants(data.features, 0.01, n_workers=5)
    got = theory.logreg_constants(feats, 0.01, n_workers=5)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    ref_p, ref_lbar = jax_theory.importance_weights(data.features, 0.01)
    got_p, got_lbar = theory.importance_weights(feats, 0.01)
    _bits_equal(got_p.numpy(), ref_p)
    assert got_lbar == ref_lbar


# -- dither and natural compression ----------------------------------------

def _edge_rows(n, d, seed):
    """Rows of every scale, with exact powers of two, one ulp either side
    of them, subnormals, zeros of both signs, ±inf and NaN."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d))
         * 10.0 ** rng.integers(-4, 4, (n, d))).astype(np.float32)
    pw = (np.float32(2.0) ** rng.integers(-126, 127, (n, d))).astype(
        np.float32)
    pick = rng.integers(0, 4, (n, d))
    x = np.where(pick == 1, pw, x)
    x = np.where(pick == 2, np.nextafter(pw, np.float32(np.inf)), x)
    x = np.where(pick == 3, -np.nextafter(pw, np.float32(0)), x)
    special = np.array([0.0, -0.0, 1e-40, -3e-39, 1.1754942e-38,
                        1.1754944e-38, np.inf, -np.inf, np.nan], np.float32)
    x[0, :min(d, special.size)] = special[:d]
    return x


@pytest.mark.parametrize("name,kw", [("dither", {}), ("dither", {"levels": 4}),
                                     ("natural", {})])
@pytest.mark.parametrize("n,d", [(5, 123), (4, 1)])
def test_dense_compressors_bit_for_bit(name, kw, n, d):
    x = _edge_rows(n, d, seed=d)
    key = jax.random.PRNGKey(d)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    ref = jax.jit(jax.vmap(jax_compressors.get_compressor(name, **kw)
                           .compress))(keys, jnp.asarray(x))
    comp = compressors.get_compressor(name, **kw)
    tkeys = key_from_numpy(keys)
    got = torch.stack([comp.compress(tkeys[i], torch.tensor(x[i]))
                       for i in range(n)])
    _bits_equal(got.numpy(), ref)


# -- importance sampling -----------------------------------------------------

@pytest.mark.parametrize("n", [400, 6512, 32561])
def test_cumsum_takes_the_reference_order(n):
    p = np.random.default_rng(n).random(n).astype(np.float32)
    p /= p.sum()
    _bits_equal(R.cumsum(torch.tensor(p)).numpy(),
                jnp.cumsum(jnp.asarray(p)))


def test_choice_and_importance_batches_equal_the_reference():
    data = jax_make_data(jax.random.PRNGKey(0), n_samples=2000, dim=12,
                         n_workers=5)
    probs, _ = jax_theory.importance_weights(data.features, 0.01)
    tprobs = torch.tensor(np.asarray(probs))
    for seed in (0, 7):
        key = jax.random.PRNGKey(seed)
        ref = jax.random.choice(key, 2000, (64,), replace=True, p=probs)
        got = R.choice(key_from_numpy(key), 2000, (64,), tprobs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        ref_b = data.sample_batches_importance(key, 32, probs)
        td = LogRegData.from_numpy(data.features, data.labels, 5)
        got_b = td.sample_batches_importance(key_from_numpy(key), 32,
                                             tprobs)
        assert sorted(got_b) == sorted(ref_b) == ["w", "x", "y"]
        for k in ref_b:
            _bits_equal(got_b[k].numpy(), ref_b[k])


# -- whole runs -------------------------------------------------------------

RUNS = {
    "sparse_support cm": dict(SPARSE),
    "sparse_support krum": dict(SPARSE, aggregator="krum"),
    "dither pallas": dict(agg_mode="pallas", compressor="dither"),
    "natural pallas": dict(agg_mode="pallas", compressor="natural"),
    "importance pallas": dict(agg_mode="pallas", compressor="randk",
                              compressor_kwargs={"ratio": 0.1},
                              data_kwargs={"sampling": "importance"}),
}


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_run_matches_reference(tag):
    spec = dict(RUNS[tag], steps=STEPS, p=RUNS[tag].get("p", 0.5))
    jspec = JaxRunSpec(**spec)
    ref = jax_run(jspec, log_every=1)
    got = run(RunSpec.from_json(jspec.to_json()), device="cpu", log_every=1)
    assert [h.get("c_k") for h in got.history] == \
        [h.get("c_k") for h in ref.history]
    assert set(h.get("c_k") for h in ref.history) == {0, 1}   # both branches
    assert got.comm_bits == ref.comm_bits
    assert [sorted(h) for h in got.history] == \
        [sorted(h) for h in ref.history]
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in ref.history],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for k in ("params", "g"):
        for name, t in got.state[k].items():
            np.testing.assert_allclose(t.numpy(), ref.state[k][name],
                                       rtol=TRAJ_TOL, atol=TRAJ_TOL)


def test_sparse_round_keeps_g_off_the_support():
    """A VR round writes g^k on the shared support alone: every other
    coordinate of g stays bit for bit."""
    spec = RunSpec(**dict(SPARSE, p=1e-6, data_kwargs={"dim": 1000,
                                                        "n_samples": 64}))
    exp = build(spec, device="cpu")
    k_init, k_run = R.split(R.PRNGKey(spec.seed))
    state = exp.method.init(exp.init_params(k_init), exp.anchor(0), k_run)
    key = R.fold_in(k_run, 1)
    k_step, k_batch = R.split(key)
    new, metrics = exp.method.step(state, exp.minibatch(0, k_batch),
                                   exp.anchor(0), k_step)
    assert metrics["c_k"] == 0
    keys = dict(zip(exp.method.estimator.rng,
                    R.split(k_step, len(exp.method.estimator.rng))))
    for i, name in enumerate(sorted(state["g"])):
        d = state["g"][name].numel()
        blk, n_units = compressors.unit_partition(d)
        k_units = max(int(0.1 * n_units), 1)
        idx = R.permutation(R.fold_in(keys["q"], i), n_units)[:k_units]
        off = torch.ones(n_units * blk, dtype=torch.bool)
        off.reshape(n_units, blk)[idx] = False
        off = off[:d]
        old, got = state["g"][name].reshape(-1), new["g"][name].reshape(-1)
        assert torch.equal(old[off], got[off])
        assert not torch.equal(old[~off], got[~off])


@pytest.mark.parametrize("override,match", [
    ({"compressor_kwargs": {"ratio": 0.1}}, "common_randomness"),
    ({"compressor": "topk", "compressor_kwargs": {"ratio": 0.1}},
     "common_randomness"),
    ({"trace": True}, "trace=True is not supported"),
])
def test_spec_refusals_equal_the_reference(override, match):
    spec = {**SPARSE, **override}
    with pytest.raises(ValueError, match=match) as ref_err:
        JaxRunSpec(**spec)
    with pytest.raises(ValueError, match=match) as err:
        RunSpec(**spec)
    assert str(err.value) == str(ref_err.value)


def test_factory_refuses_a_sparse_support_without_common_randomness():
    from repro_torch.core.byz_vr_marina import ByzVRMarinaConfig
    from repro_torch.core.estimators import get_estimator
    cfg = ByzVRMarinaConfig(n_workers=5, n_byz=1, agg_mode="sparse_support",
                            compressor=compressors.rand_k(0.1))
    with pytest.raises(ValueError, match="common-randomness RandK"):
        get_estimator("marina", cfg)
