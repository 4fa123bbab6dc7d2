"""The streaming service's pieces (``repro_torch.serve``, the weighted
``engine.ingest_message_phase``, ``ServeSpec`` and its CLI) against the
reference on inputs made from a seed.

* Arrivals are numpy in both packages: the port's stream equals the
  reference's event for event, for every latency mode and chaos knob, and
  a trace saved by one package replays in the other.
* The double buffer keeps the reference's dedup counters and slots on the
  same offer sequence; the staleness weights are the reference's bit for
  bit.
* ``ingest_message_phase`` on gspmd and on the kernels' plain versions,
  with a per-call byzantine mask and staleness weights: under IPM,
  coordinate rules bit for bit against the reference's eager phase (its
  own oracle form) and norm rules to 2e-5; under ALIE every rule to 2e-5
  against the jitted reference (the std sums in XLA's order); the traced
  twin's aggregate bit for bit its untraced phase's, its influence
  (pushed back through the weights) to 2e-5 of the reference's.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import ServeSpec as JaxServeSpec
from repro.core import engine as jax_engine
from repro.obs import trace as jax_trace
from repro.serve import ArrivalProcess as JaxArrivals
from repro.serve import DoubleBuffer as JaxBuffer
from repro.serve import staleness_weights as jax_staleness_weights
from repro_torch.api import RunSpec, ServeSpec
from repro_torch.convert import key_from_numpy
from repro_torch.core import engine
from repro_torch.obs import trace
from repro_torch.serve import (ArrivalProcess, DoubleBuffer,
                               staleness_weights)

TOL = 2e-5

# ---------------------------------------------------------------------------
# arrivals
# ---------------------------------------------------------------------------

ARRIVALS = {
    "const": ("const", 5, dict(latency=1.0)),
    "const stragglers dropout": ("const", 6, dict(
        latency=0.5, straggler_frac=0.34, straggler_factor=3.0,
        dropout=0.2)),
    "exp chaos": ("exp", 8, dict(mean_latency=1.0, straggler_frac=0.25,
                                 straggler_factor=4.0, dropout=0.1,
                                 duplicate=0.25, replay_lag=0.3)),
    "lognormal": ("lognormal", 5, dict(mean_latency=0.7, sigma=1.2,
                                       duplicate=0.2)),
    "exp crash hang": ("exp", 6, dict(mean_latency=1.0, dropout=0.05,
                                      duplicate=0.1, crash=0.12, hang=0.15,
                                      recovery_lag=2.5, hang_lag=4.0)),
}


def _take(proc, n, start=0):
    out = []
    for ev in proc.events(start=start):
        out.append(ev.to_dict())
        if len(out) >= n:
            break
    return out


@pytest.mark.parametrize("tag", sorted(ARRIVALS))
def test_arrivals_match_reference_event_for_event(tag):
    mode, n, kw = ARRIVALS[tag]
    got = _take(ArrivalProcess(mode, n, seed=11, **kw), 150)
    assert got == _take(JaxArrivals(mode, n, seed=11, **kw), 150)
    assert _take(ArrivalProcess(mode, n, seed=11, **kw), 50,
                 start=100) == got[100:]          # resume == skip
    ts = [e["t"] for e in got]
    assert ts == sorted(ts)
    if "crash" in kw:
        assert any(e["crashed"] for e in got) and any(e["hung"] for e in got)


def test_arrival_trace_replays_across_packages(tmp_path):
    """A trace saved by either package replays in the other; a trace of
    events given inline replays as well."""
    mode, n, kw = ARRIVALS["exp crash hang"]
    p_port, p_ref = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    saved = [e.to_dict() for e in
             ArrivalProcess(mode, n, seed=3, **kw).save_trace(p_port, 80)]
    ref_saved = [e.to_dict() for e in
                 JaxArrivals(mode, n, seed=3, **kw).save_trace(p_ref, 80)]
    assert saved == ref_saved
    assert _take(JaxArrivals("trace", n, path=p_port), 80) == saved
    assert _take(ArrivalProcess("trace", n, path=p_ref), 80) == saved
    assert _take(ArrivalProcess("trace", n, events=saved), 80,
                 start=30) == saved[30:]


def test_arrivals_reject_what_the_reference_rejects():
    for args, kw in ((("poisson", 4), {}), (("exp", 0), {}),
                     (("exp", 4), {"dropout": 1.0}),
                     (("trace", 4), {})):
        with pytest.raises(ValueError):
            JaxArrivals(*args, **kw)
        with pytest.raises(ValueError):
            ArrivalProcess(*args, **kw)


# ---------------------------------------------------------------------------
# buffer and weights
# ---------------------------------------------------------------------------

def test_buffer_matches_reference_on_one_offer_sequence():
    rng = np.random.default_rng(0)
    n, k = 6, 3
    rows = rng.standard_normal((n, 5)).astype(np.float32)
    port, ref = DoubleBuffer(k, n), JaxBuffer(k, n, donate=False)
    tree_p, tree_r = {"w": torch.tensor(rows)}, {"w": jnp.asarray(rows)}
    seq = np.zeros(n, np.int64)
    swaps = 0
    for step in range(60):
        c = int(rng.integers(n))
        if rng.random() < 0.7:
            seq[c] += 1                      # a fresh dispatch, else a replay
        s, v = int(seq[c]), int(step // 7)
        assert port.offer(c, s, v, tree_p) == ref.offer(c, s, v, tree_r)
        assert port.stats == ref.stats and port.count == ref.count
        if port.full():
            got, want = port.swap(), ref.swap()
            for a, b in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(got[0]["w"].numpy(),
                                          np.asarray(want[0]["w"]))
            np.testing.assert_array_equal(got[0]["w"].numpy(),
                                          rows[got[1]])
            swaps += 1
    assert swaps >= 5 and port.stats["rej_replay"] > 0 \
        and port.stats["rej_dup_client"] > 0
    np.testing.assert_array_equal(port.last_accepted, ref.last_accepted)


def test_staleness_weights_bit_for_bit():
    rng = np.random.default_rng(1)
    for k in (1, 4, 8, 72):
        tau = rng.integers(0, 9, size=k)
        got, want = staleness_weights(tau), jax_staleness_weights(tau)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(staleness_weights(np.zeros(5, np.int64)),
                                  np.ones(5, np.float32))


# ---------------------------------------------------------------------------
# ingest_message_phase
# ---------------------------------------------------------------------------

def _phase(rule, bucket, mode, k=6, n_byz=1, d=33, seed=0, attack="ALIE",
           **spec_kw):
    """Both packages' configs, a (K, ...) candidate stack, a per-call
    byzantine mask, staleness weights and the two keys."""
    spec = dict(n_workers=k, n_byz=n_byz, attack=attack, aggregator=rule,
                bucket_size=bucket, agg_mode=mode, **spec_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = JaxRunSpec(**spec).build_config()
        cfg = RunSpec(**spec).build_config()
    rng = np.random.default_rng(seed)
    cand = {"b": rng.standard_normal(k).astype(np.float32),
            "w": rng.standard_normal((k, d)).astype(np.float32)}
    byz = rng.random(k) < 0.3
    byz[:2] = (True, False)
    w = staleness_weights(rng.integers(0, 6, size=k))
    ka, kg = jax.random.split(jax.random.PRNGKey(seed + 4))
    return jcfg, cfg, cand, byz, w, ka, kg


def _run_both(jcfg, cfg, cand, byz, w, ka, kg, traced=False, jit=True):
    """The port's phase and the reference's, under ``jax.jit`` or, with
    ``jit`` False, eagerly (its own oracle form)."""
    fn = (jax_trace.traced_ingest_message_phase if traced
          else jax_engine.ingest_message_phase)

    def ref(c, m, ws):
        return fn(jcfg, ka, kg, c, byz_mask=m, weights=ws)

    want = (jax.jit(ref) if jit else ref)(
        {k: jnp.asarray(v) for k, v in cand.items()}, jnp.asarray(byz),
        jnp.asarray(w))
    got = engine.ingest_message_phase(
        cfg, key_from_numpy(ka), key_from_numpy(kg),
        {k: torch.tensor(v) for k, v in cand.items()},
        byz_mask=torch.tensor(byz), weights=torch.tensor(w), trace=traced)
    return got, want


def _assert_agg(got, want, exact):
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-6,
                                       err_msg=k)


COORD = ("cm", "tm", "mean")


@pytest.mark.parametrize("mode", ["gspmd", "pallas"])
@pytest.mark.parametrize("rule,bucket", [("cm", 2), ("mean", 0),
                                         ("krum", 0), ("rfa", 2)])
def test_ingest_message_phase_matches_reference(mode, rule, bucket):
    """IPM (its statistic, the good rows' mean, sums in the same order in
    both packages): coordinate rules bit for bit, norm rules to 2e-5. The
    plain backend's coordinate rules are held to the reference's eager
    phase, its own oracle form: under ``jax.jit`` XLA contracts the scale
    into the bucket mean (a fused multiply-add), which parts from the
    separate product and sum by ulps of a cancelling pair."""
    jcfg, cfg, cand, byz, w, ka, kg = _phase(rule, bucket, mode,
                                             attack="IPM")
    exact = rule in COORD
    got, want = _run_both(jcfg, cfg, cand, byz, w, ka, kg,
                          jit=not (exact and mode == "gspmd"))
    _assert_agg(got, want, exact=exact)


@pytest.mark.parametrize("mode", ["gspmd", "pallas"])
@pytest.mark.parametrize("rule,bucket", [("cm", 2), ("krum", 0)])
def test_ingest_message_phase_alie_matches_reference(mode, rule, bucket):
    """ALIE, whose forged value m - z·s the port rounds once, as the
    compiled reference does (a fused multiply-add). On the kernels cm
    equals the jitted reference bit for bit. The plain backend's cm is
    held to the eager reference within 2 ulps: under ``jax.jit`` XLA also
    contracts the scale into the bucket mean (see the IPM test), and
    eagerly it rounds the forged value twice, one ulp of a forged row
    that the bucket mean and the scale carry to at most two. Norm rules
    to 2e-5."""
    jcfg, cfg, cand, byz, w, ka, kg = _phase(rule, bucket, mode, seed=1)
    plain_cm = rule in COORD and mode == "gspmd"
    got, want = _run_both(jcfg, cfg, cand, byz, w, ka, kg, jit=not plain_cm)
    if plain_cm:
        for k in want:
            np.testing.assert_array_max_ulp(got[k].numpy(),
                                            np.asarray(want[k]), maxulp=2)
    else:
        _assert_agg(got, want, exact=rule in COORD)


@pytest.mark.parametrize("mode,rule,bucket", [("pallas", "krum", 0),
                                              ("pallas", "cm", 2),
                                              ("gspmd", "rfa", 2)])
def test_traced_ingest_matches_reference(mode, rule, bucket):
    """The traced twin: the aggregate equals the untraced phase's bit for
    bit, and the trace (per-call mask, influence through the weights)
    matches the reference's."""
    jcfg, cfg, cand, byz, w, ka, kg = _phase(rule, bucket, mode, seed=2)
    (agg, rt), (jagg, jrt) = _run_both(jcfg, cfg, cand, byz, w, ka, kg,
                                       traced=True)
    plain = engine.ingest_message_phase(
        cfg, key_from_numpy(ka), key_from_numpy(kg),
        {k: torch.tensor(v) for k, v in cand.items()},
        byz_mask=torch.tensor(byz), weights=torch.tensor(w))
    for k in agg:
        assert torch.equal(agg[k], plain[k])
    _assert_agg(agg, jagg, exact=False)
    got, ref = trace.to_host(rt), jax_trace.to_host(jrt)
    assert sorted(got) == sorted(ref)
    assert got["byz_mask"] == ref["byz_mask"] == byz.tolist()
    for f in ("influence", "bucket_weights", "dist_to_agg", "krum_scores",
              "rfa_weights"):
        if f in ref:
            np.testing.assert_allclose(got[f], ref[f], rtol=TOL, atol=TOL,
                                       err_msg=f)
    if rule == "krum":
        assert got["krum_selected"] == ref["krum_selected"]
        # one selected row: its staleness weight, not 1
        assert sum(got["influence"]) == pytest.approx(
            float(w[got["krum_selected"]]), rel=1e-6)


@pytest.mark.parametrize("mode", ["gspmd", "pallas"])
def test_guarded_ingest_with_a_nan_row(mode):
    jcfg, cfg, cand, byz, w, ka, kg = _phase("cm", 2, mode, seed=5,
                                             attack="IPM", fault_guard=True)
    cand["w"][3, 7] = np.nan
    byz[3] = False
    got, want = _run_both(jcfg, cfg, cand, byz, w, ka, kg,
                          jit=mode == "pallas")
    _assert_agg(got, want, exact=True)
    assert all(torch.isfinite(v).all() for v in got.values())


def test_ingest_giant_buffer():
    """K = 72 > 64 buffered updates: the giant-n tier scales the flat rows
    before bucketing, bit for bit."""
    jcfg, cfg, cand, byz, w, ka, kg = _phase("cm", 2, "pallas", k=72,
                                             n_byz=8, d=5, seed=7,
                                             attack="IPM")
    got, want = _run_both(jcfg, cfg, cand, byz, w, ka, kg, jit=False)
    _assert_agg(got, want, exact=True)


@pytest.mark.parametrize("mode", ["gspmd", "pallas"])
def test_fedbuff_weighted_mean_identity(mode):
    """rule=mean with the service's normalized weights is the FedBuff
    weighted mean Σ_i s_i u_i / Σ_j s_j."""
    k = 5
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = RunSpec(n_workers=k, n_byz=0, attack="NA", aggregator="mean",
                      bucket_size=0, agg_mode=mode).build_config()
    rng = np.random.default_rng(2)
    cand = {"b": rng.standard_normal(k).astype(np.float32),
            "w": rng.standard_normal((k, 17)).astype(np.float32)}
    tau = np.array([0, 1, 4, 2, 0])
    ka, kg = torch.tensor([0, 5]), torch.tensor([0, 6])
    got = engine.ingest_message_phase(
        cfg, ka, kg, {n: torch.tensor(v) for n, v in cand.items()},
        byz_mask=torch.zeros(k, dtype=torch.bool),
        weights=torch.tensor(staleness_weights(tau)))
    s = 1.0 / np.sqrt(1.0 + tau)
    for n, v in cand.items():
        np.testing.assert_allclose(got[n].numpy(),
                                   np.tensordot(s / s.sum(), v, axes=1),
                                   rtol=TOL, atol=1e-6)


def test_ingest_without_mask_and_weights_is_message_phase():
    jcfg, cfg, cand, byz, w, ka, kg = _phase("rfa", 2, "pallas")
    tc = {k: torch.tensor(v) for k, v in cand.items()}
    a = engine.ingest_message_phase(cfg, key_from_numpy(ka),
                                    key_from_numpy(kg), tc)
    b = engine.message_phase(cfg, key_from_numpy(ka), key_from_numpy(kg),
                             tc)
    assert all(torch.equal(a[k], b[k]) for k in a)
    from repro_torch.core import wire
    wc = wire.WireCandidates.__new__(wire.WireCandidates)
    with pytest.raises(TypeError):
        engine.ingest_message_phase(cfg, key_from_numpy(ka),
                                    key_from_numpy(kg), wc,
                                    byz_mask=torch.tensor(byz))


# ---------------------------------------------------------------------------
# ServeSpec and the CLI
# ---------------------------------------------------------------------------

TINY = dict(method="sgd", n_clients=6, n_byz=1, attack="ALIE",
            aggregator="cm", bucket_size=2, buffer_size=3, rounds=3,
            agg_mode="pallas", arrival="exp", seed=2,
            arrival_kwargs={"mean_latency": 1.0, "duplicate": 0.2},
            data_kwargs={"dim": 8, "n_samples": 48, "batch_size": 4})


@pytest.mark.parametrize("kw,exc,match", [
    (dict(n_clients=4, n_byz=1, buffer_size=5), ValueError, "buffer_size"),
    (dict(n_clients=8, n_byz=4), ValueError, "robust aggregator exists"),
    (dict(method="marina", n_clients=8, n_byz=1), ValueError, "streamable"),
    (dict(agg_mode="all_to_all"), ValueError, "agg_mode"),
    (dict(arrival="trace"), ValueError, "arrival='trace'"),
    (dict(staleness="linear"), ValueError, "staleness"),
    (dict(aggregator="krun"), ValueError, "did you mean"),
    (dict(arrival_kwargs={"x": object()}), ValueError, "round-trip"),
])
def test_serve_spec_validation_as_the_reference(kw, exc, match):
    for cls in (JaxServeSpec, ServeSpec):
        with pytest.raises(exc, match=match):
            cls(**kw)


def test_serve_spec_json_and_lm():
    with pytest.warns(UserWarning, match="buffered byzantine"):
        ServeSpec(n_clients=12, n_byz=3, buffer_size=4)
    spec = ServeSpec(**TINY)
    ref = JaxServeSpec(**TINY)
    assert spec.to_dict() == ref.to_dict()
    assert ServeSpec.from_json(ref.to_json()) == spec
    assert JaxServeSpec.from_json(spec.to_json()) == ref
    assert spec.replace(**{"arrival_kwargs.dropout": 0.1}).arrival_kwargs \
        == {"mean_latency": 1.0, "duplicate": 0.2, "dropout": 0.1}
    assert spec.to_run_spec().to_dict() == ref.to_run_spec().to_dict()
    with pytest.raises(ValueError, match="kind"):
        ServeSpec.from_dict({**spec.to_dict(), "kind": "run"})
    lm = dict(task="lm", arch="qwen3-1.7b")
    assert ServeSpec(**lm).to_dict() == JaxServeSpec(**lm).to_dict()
    with pytest.raises(NotImplementedError, match="queue 1, item 15"):
        ServeSpec(task="lm", arch="mamba2-130m")
    with pytest.raises(ValueError, match="needs arch") as err:
        ServeSpec(task="lm")
    with pytest.raises(ValueError, match="needs arch") as ref_err:
        JaxServeSpec(task="lm")
    assert str(err.value) == str(ref_err.value)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal")
def test_serve_needs_the_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeSpec(**TINY).build()
    from repro_torch.launch import serve_agg
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_agg.main(["--rounds", "1", "--quiet"])


def test_serve_agg_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve_agg
    out, spec_out = tmp_path / "res.json", tmp_path / "spec.json"
    serve_agg.main(["--method", "sgd", "--n-clients", "6", "--n-byz", "1",
                    "--aggregator", "cm", "--bucket-size", "2",
                    "--buffer-size", "3", "--rounds", "3", "--agg-mode",
                    "pallas", "--seed", "2", "--chaos",
                    "mean_latency=1.0,duplicate=0.2", "--data-kwargs",
                    "dim=8,n_samples=48,batch_size=4", "--device", "cpu",
                    "--sync-each-fire", "--quiet", "--metrics-out",
                    str(out), "--spec-out", str(spec_out)])
    assert "[serve_agg] 3 rounds" in capsys.readouterr().out
    res = json.loads(out.read_text())
    assert ServeSpec.from_json(spec_out.read_text()) == ServeSpec(**TINY)
    direct = ServeSpec(**TINY).run(device="cpu")
    assert [h["loss"] for h in res["history"]] == \
        [h["loss"] for h in direct.history]
    assert res["stats"] == direct.stats
    assert "p50_ms" in res
