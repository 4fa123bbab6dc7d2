"""Whole runs of the method zoo and of the RN attack against the
reference: one ``run(spec)`` in each package, losses, params and every
estimator state entry to 2e-5, the communication count and each round's
``wire_bits`` equal. Under ``agg_mode="pallas"`` the port's CPU path goes
through the kernels' entry points (their plain versions here), so the
calls are counted: dense candidates take one call an aggregation on the
packed b+w segment, a wire payload one on each leaf. RN has no load form,
so a MARINA + RandK round under RN rebuilds its candidates densely.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import run as jax_run
from repro.core.attacks import get_attack as jax_get_attack
from repro_torch import random as R
from repro_torch.api import RunSpec, run
from repro_torch.api.runner import build
from repro_torch.convert import key_from_numpy
from repro_torch.core import engine
from repro_torch.core.attacks import get_attack
from repro_torch.kernels import norm_agg
from repro_torch.kernels.robust_agg import robust_agg

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TRAJ_TOL = 2e-5
STEPS = 6
BASE = dict(n_workers=5, n_byz=1, attack="ALIE", aggregator="cm",
            bucket_size=2, agg_mode="pallas", compressor="randk",
            compressor_kwargs={"ratio": 0.5}, p=0.3, lr=0.25, steps=STEPS,
            seed=3, data_kwargs={"dim": 30, "n_samples": 60,
                                 "batch_size": 8})
_METHOD_KW = {"svrg": {"aggregator": "rfa"},
              "saga": {"method_kwargs": {"batch_size": 8}}}
WIRE = ("csgd", "diana", "cmfilter")
FNS = {"robust_agg": robust_agg, "rfa_iter": norm_agg.rfa_iter,
       "weighted_sum": norm_agg.weighted_sum}


def _close(got, ref, what=""):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), what
        for k in ref:
            _close(got[k], ref[k], f"{what}.{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=TRAJ_TOL, atol=TRAJ_TOL, err_msg=what)


def _both(**kw):
    """The run in both packages, the port's entry-point calls counted."""
    jspec = JaxRunSpec(**{**BASE, **kw})
    ref = jax_run(jspec, log_every=1)
    for fn in FNS.values():
        fn.calls = fn.launches = 0
    got = run(RunSpec.from_json(jspec.to_json()), device="cpu", log_every=1)
    calls = {k: fn.calls for k, fn in FNS.items()}
    assert all(fn.launches == 0 for fn in FNS.values())     # plain on CPU
    assert got.comm_bits == ref.comm_bits
    assert [sorted(h) for h in got.history] == \
        [sorted(h) for h in ref.history]
    assert [h.get("wire_bits") for h in got.history] == \
        [h.get("wire_bits") for h in ref.history]
    assert [h.get("c_k") for h in got.history] == \
        [h.get("c_k") for h in ref.history]
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in ref.history],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for k in sorted(set(ref.state) - {"opt_state", "step"}):
        tv = got.state[k]
        _close({n: t.numpy() for n, t in tv.items()} if isinstance(tv, dict)
               else tv.numpy(), ref.state[k], k)
    return got, ref, calls


@pytest.mark.parametrize("method", ["sgd", "sgdm", "csgd", "diana", "mvr",
                                    "svrg", "cmfilter", "saga"])
def test_run_matches_reference(method):
    got, ref, calls = _both(method=method, **_METHOD_KW.get(method, {}))
    # the dim-30 leaves w and b pack into one dense segment; a wire payload
    # does not pack; svrg's RFA makes 8 Weiszfeld passes and a sum
    per_agg = 2 if method in WIRE else 1
    if method == "svrg":
        want = {"robust_agg": 0, "rfa_iter": 8 * STEPS,
                "weighted_sum": STEPS}
    else:
        want = {"robust_agg": per_agg * STEPS, "rfa_iter": 0,
                "weighted_sum": 0}
    assert calls == want


@pytest.mark.parametrize("shape", [(5, 30), (5,), (5, 3, 7)])
def test_random_noise_bit_for_bit(shape):
    """RN under jax.jit, as the reference's runner compiles it: XLA folds
    scale·sqrt(2) into one float32 constant."""
    key = jax.random.PRNGKey(sum(shape))
    scales = (10.0, 0.3)
    wants = jax.jit(lambda k, x: [jax_get_attack("RN", scale=sc).apply(
        k, x, None, None) for sc in scales])(key, jnp.ones(shape, jnp.float32))
    for scale, want in zip(scales, wants):
        got = get_attack("RN", scale=scale).apply(
            key_from_numpy(key), torch.ones(shape), None, None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert get_attack("RN").coord_apply is None


@pytest.mark.parametrize("guard", [False, True])
def test_marina_randk_rn_run_matches_reference(guard):
    got, ref, calls = _both(method="marina", attack="RN", steps=8,
                            fault_guard=guard)
    ck = [int(h["c_k"]) for h in got.history]
    assert 0 < sum(ck) < len(ck)           # full and VR rounds both ran
    # every aggregation, the init's and each VR round's too, is dense and
    # packed: RN leaves the wire's fused load
    assert calls == {"robust_agg": 1 + len(ck), "rfa_iter": 0,
                     "weighted_sum": 0}


@pytest.mark.parametrize("method", ["saga", "sgdm"])
def test_partial_participation_matches_reference(method):
    """Runs under participation 0.8 match the reference, and a worker
    left out of a round keeps its table or momentum bit for bit."""
    kw = dict(method=method, participation=0.8, **_METHOD_KW.get(method, {}))
    _both(**kw)
    exp = build(RunSpec(**{**BASE, **kw}), device="cpu")
    k_init, k_run = R.split(R.PRNGKey(BASE["seed"]))
    state = exp.method.init(exp.init_params(k_init), exp.anchor(0), k_run)
    frozen = 0
    for it in range(3):
        k_step, k_batch = R.split(R.fold_in(k_run, it + 1))
        new, _ = exp.method.step(state, exp.minibatch(it, k_batch),
                                 exp.anchor(it), k_step)
        sampled = engine.sampled_worker_mask(exp.cfg, k_step)
        assert int(sampled.sum()) == 4
        for key in (k for k in new if k.startswith("worker_")):
            for leaf, old in zip(new[key].values(), state[key].values()):
                for i in np.flatnonzero(~sampled.numpy()):
                    assert torch.equal(leaf[i], old[i])
                    frozen += 1
        state = new
    assert frozen


def test_spec_refuses_saga_on_lm():
    spec = dict(task="lm", arch="qwen3-1.7b", method="saga")
    with pytest.raises(ValueError, match="FIXED anchor") as ref_err:
        JaxRunSpec(**spec)
    with pytest.raises(ValueError, match="FIXED anchor") as err:
        RunSpec(**spec)
    assert str(err.value) == str(ref_err.value)
