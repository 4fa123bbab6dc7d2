"""The port's main path against the reference: Byz-VR-MARINA with RandK,
ALIE and bucketed coordinate-wise median, RFA or Krum, one engine step at
a time and as whole runs of one spec, at 5 workers and, through the
giant-n tier, at 130. Trajectories agree to 2e-5, the
pallas≡gspmd tolerance of the reference's own estimator contract; the c_k
coins and the communication count agree exactly."""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import run as jax_run
from repro.api.runner import build as jax_build
from repro_torch.api import RunSpec, registry, run
from repro_torch.api.runner import build
from repro_torch.convert import key_from_numpy, state_from_numpy, tree_from_numpy
from repro_torch.core.theory import delta_over_active_set
from repro_torch.kernels import norm_agg

TRAJ_TOL = 2e-5
SPEC = dict(agg_mode="pallas", compressor="randk",
            compressor_kwargs={"ratio": 0.1}, p=0.3, steps=12,
            data_kwargs={"dim": 40, "n_samples": 200, "batch_size": 8})
PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _close(got, ref):
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL)


@pytest.mark.parametrize("agg_mode", ["pallas", "gspmd"])
def test_engine_init_and_one_step_of_each_branch(agg_mode):
    """JAX state, batch, anchor and keys carried across through convert."""
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
    seen = set()
    for it in range(12):
        k_step, k_batch = jax.random.split(jax.random.fold_in(k_run, it + 1))
        batch = jexp.minibatch(it, k_batch)
        jnew, jm = jexp.method.step(jstate, batch, anchor, k_step)
        tnew, tm = texp.method.step(
            state_from_numpy({**jstate, "params": _np(jstate["params"]),
                              "g": _np(jstate["g"])}),
            tree_from_numpy(_np(batch)), tree_from_numpy(_np(anchor)),
            key_from_numpy(k_step))
        assert tm["c_k"] == int(jm["c_k"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL)
        assert tm["wire_bits"] == float(jm["wire_bits"])
        _close(tnew["params"], jnew["params"])
        _close(tnew["g"], jnew["g"])
        seen.add(tm["c_k"])
        if seen == {0, 1}:
            break
        jstate = jnew
    assert seen == {0, 1}


def _norm_calls(ck, aggregator):
    """Entry-point calls of a norm rule's run on the main-path spec: one
    init aggregation, F full rounds on one packed segment, V VR rounds on
    two wire leaves, T = 8 Weiszfeld passes."""
    full = 1 + sum(ck)
    vr = len(ck) - sum(ck)
    if aggregator == "rfa":
        return {"pair_gram": 0, "rfa_iter": 8 * full + 16 * vr,
                "weighted_sum": full + 2 * vr}
    return {"pair_gram": full + 2 * vr, "rfa_iter": 0,
            "weighted_sum": full + 2 * vr}


@pytest.mark.parametrize("agg_mode", ["pallas", "gspmd"])
@pytest.mark.parametrize("aggregator", ["cm", "rfa", "krum"])
def test_run_matches_reference(aggregator, agg_mode):
    jspec = JaxRunSpec(**{**SPEC, "agg_mode": agg_mode,
                          "aggregator": aggregator})
    ref = jax_run(jspec, log_every=1)
    fns = {"pair_gram": norm_agg.pair_gram, "rfa_iter": norm_agg.rfa_iter,
           "weighted_sum": norm_agg.weighted_sum}
    for fn in fns.values():
        fn.calls = fn.launches = 0
    got = run(RunSpec.from_json(jspec.to_json()), device="cpu", log_every=1)
    ck = [int(h["c_k"]) for h in got.history]
    assert ck == [int(h["c_k"]) for h in ref.history]
    assert set(ck) == {0, 1}
    assert got.comm_bits == ref.comm_bits
    assert got.n_params == ref.n_params
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in ref.history],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    _close(got.params, ref.params)
    calls = {k: fn.calls for k, fn in fns.items()}
    if agg_mode == "pallas" and aggregator != "cm":
        assert calls == _norm_calls(ck, aggregator)
    else:
        assert calls == dict.fromkeys(fns, 0)
    assert all(fn.launches == 0 for fn in fns.values())    # plain on CPU


GIANT = dict(n_workers=130, n_byz=13,
             data_kwargs={"dim": 40, "n_samples": 1300, "batch_size": 8})


def _blocked_calls(ck, aggregator, agg_mode):
    """Blocked entry-point calls of a run at n = 130 (m = 65 buckets): one
    init aggregation and one per round, each over the two leaves b and w
    (the tier does not pack them); RFA makes T = 8 Weiszfeld passes."""
    aggs = 1 + len(ck)
    if agg_mode == "gspmd" or aggregator == "cm":
        return {"pair_gram_blocked": 0, "sqdist_to_blocked": 0,
                "weighted_sum_blocked": 0}
    if aggregator == "rfa":
        return {"pair_gram_blocked": 0, "sqdist_to_blocked": 2 * 8 * aggs,
                "weighted_sum_blocked": 2 * 9 * aggs}
    return {"pair_gram_blocked": 2 * aggs, "sqdist_to_blocked": 0,
            "weighted_sum_blocked": 2 * aggs}


@pytest.mark.parametrize("aggregator, agg_mode", [
    ("cm", "pallas"), ("rfa", "pallas"), ("krum", "pallas"),
    ("krum", "gspmd")])
def test_giant_n_run_matches_reference(aggregator, agg_mode):
    """More than 64 workers: the giant-n tier under pallas (the blocked
    drivers, as s = 2 leaves m = 65 rows), the plain Gram under gspmd."""
    jspec = JaxRunSpec(**{**SPEC, **GIANT, "agg_mode": agg_mode,
                          "aggregator": aggregator})
    ref = jax_run(jspec, log_every=1)
    names = ("pair_gram_blocked", "sqdist_to_blocked",
             "weighted_sum_blocked")
    fns = {k: getattr(norm_agg, k) for k in names}
    for fn in fns.values():
        fn.calls = fn.launches = 0
    got = run(RunSpec.from_json(jspec.to_json()), device="cpu", log_every=1)
    ck = [int(h["c_k"]) for h in got.history]
    assert ck == [int(h["c_k"]) for h in ref.history]
    assert set(ck) == {0, 1}
    assert got.comm_bits == ref.comm_bits
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in ref.history],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    _close(got.params, ref.params)
    assert {k: fn.calls for k, fn in fns.items()} == _blocked_calls(
        ck, aggregator, agg_mode)
    assert all(fn.launches == 0 for fn in fns.values())    # plain on CPU


def test_giant_n_spec_validates():
    """256 workers with 32 byzantine: δ = 0.125, and 0.25 over the s = 2
    buckets, below 1/2, so the spec builds without a warning."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        spec = RunSpec(**{**SPEC, "n_workers": 256, "n_byz": 32,
                          "aggregator": "rfa"})
        exp = build(spec, device="cpu")
    assert delta_over_active_set(256, 32, bucket_size=2) == 0.25
    assert exp.cfg.n_workers == 256 and exp.data.n_workers == 256


def test_run_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(RunSpec(**SPEC))


def test_spec_json_is_shared():
    jspec = JaxRunSpec(**SPEC)
    tspec = RunSpec.from_json(jspec.to_json())
    assert tspec.to_dict() == jspec.to_dict()
    assert JaxRunSpec.from_json(tspec.to_json()) == jspec


# the fault layer and partial participation are ported (their tests are
# tests/test_torch_faults.py and tests/test_torch_participation.py), and
# so are the int8, sign and bf16 compressors (tests/test_torch_wire_formats
# .py), every method and the RN attack (tests/test_torch_estimators.py),
# the rest of the zoo (sparse support, dither, natural compression,
# importance sampling: tests/test_torch_zoo_rest.py) and tracing
# (tests/test_torch_obs.py), and so are the dense decoders' LM task and
# the optimizers (tests/test_torch_lm_model.py, test_torch_lm_train.py);
# the cases that named them now name what is still unported: the LM task
# on the MoE, MLA + MoE, state-space and recurrent configs, and the
# all_to_all backend on either task; and, through the registry,
# resolving those four archs
_UNPORTED_ARCHS = {"phi3.5-moe-42b-a6.6b": 14, "deepseek-v2-lite-16b": 14,
                   "mamba2-130m": 15, "recurrentgemma-2b": 15}


@pytest.mark.parametrize("override", [
    {"task": "lm", "arch": "phi3.5-moe-42b-a6.6b"},
    {"task": "lm", "arch": "deepseek-v2-lite-16b"},
    {"task": "lm", "arch": "mamba2-130m"},
    {"task": "lm", "arch": "recurrentgemma-2b"},
    {"agg_mode": "all_to_all"},
    {"task": "lm", "arch": "qwen3-1.7b", "agg_mode": "all_to_all"},
    {"task": "lm", "arch": "qwen2-vl-2b", "agg_mode": "all_to_all"},
    {"task": "lm", "arch": "musicgen-medium", "agg_mode": "all_to_all"},
    ("arch", "phi3.5-moe-42b-a6.6b"),
    ("arch", "deepseek-v2-lite-16b"),
    ("arch", "mamba2-130m"),
    ("arch", "recurrentgemma-2b"),
])
def test_unported_components_raise(override):
    if isinstance(override, tuple):
        item = _UNPORTED_ARCHS[override[1]]
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP queue 1, item {item}"):
            registry.resolve(*override)
        return
    item = _UNPORTED_ARCHS.get(override.get("arch"), 11)
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1, item {item}"):
        build(RunSpec(**{**SPEC, **override}), device="cpu")


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted(PORT_ROOT.rglob("*.py"))
    assert len(files) >= 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
