"""Whole runs of the streaming service (``repro_torch.serve.service``)
against the reference's and against the port's own guarantees.

* Against the reference (``repro.serve``) on its tests' chaos spec
  (sgdm, IPM, K = 4 of 8 clients, stragglers, dropout, duplicates): the
  params to 2e-5 (the trajectories' tolerance), every host field of the
  history, the stats and the staleness histogram equal; the sink's
  counters and occupancy gauge equal the reference's events; the traced
  Krum run's influence equal to the reference's, entry for entry, to
  2e-5 (it sums to a fire's staleness weight of the picked row, above 1
  at times, where the reference's own test bounds it by 1 + 1e-4).
* The sync limit (K = n, const latency, no chaos): the port's service is
  the port's synchronous run bit for bit on either backend (no jit here
  to part them), and on the kernels within 2.98e-8 of the reference's
  service, the gap the reference's own service and engine show.
* Replay, dedup and fault labels are invisible to the trajectory; a run
  killed mid-buffer and resumed from its checkpoint ends bit for bit as
  the uninterrupted one, also when the checkpoint was written by the
  reference.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.api import ServeSpec as JaxServeSpec
from repro.obs.sink import RingSink as JaxRingSink
from repro_torch.api import ServeSpec
from repro_torch.obs.sink import RingSink
from repro_torch.serve import params_digest

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TOL = 2e-5
SYNC_GAP = 2.98e-8
HOST = ("round", "t_virtual", "staleness_mean", "staleness_max",
        "byz_in_buffer", "delta_active", "cursor")

CHAOS = dict(task="logreg", method="sgdm", n_clients=8, n_byz=1,
             attack="IPM", aggregator="cm", buffer_size=4, rounds=4,
             lr=0.3, arrival="exp", seed=11, agg_mode="pallas",
             arrival_kwargs={"mean_latency": 1.0, "straggler_frac": 0.25,
                             "straggler_factor": 4.0, "dropout": 0.1,
                             "duplicate": 0.25},
             data_kwargs={"dim": 12, "n_samples": 96, "batch_size": 8})
FAULTS = {"mean_latency": 1.0, "dropout": 0.05, "duplicate": 0.15,
          "crash": 0.12, "hang": 0.15, "recovery_lag": 2.0, "hang_lag": 4.0}
SYNC = dict(task="logreg", method="sgd", n_clients=6, n_byz=2,
            attack="ALIE", aggregator="cm", buffer_size=6, rounds=5,
            lr=0.5, arrival="const", seed=3, bucket_size=2,
            data_kwargs={"dim": 10, "n_samples": 60, "batch_size": 8})


def _port(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ServeSpec(**{**CHAOS, **kw})


def _ref(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxServeSpec(**{**CHAOS, **kw})


def _params_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _params_close(got, want, tol):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)


def _host(history):
    return [{k: m[k] for k in HOST} for m in history]


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's runs the tests share: the chaos spec on its
    kernels, with a sink, and traced Krum."""
    ring = JaxRingSink()
    return {"pallas": _ref().build().run(sink=ring), "ring": ring,
            "krum": _ref(aggregator="krum", bucket_size=0,
                         trace=True).build().run()}


@pytest.mark.parametrize("mode", ["gspmd", "pallas"])
def test_service_matches_reference(ref_runs, mode):
    """Each backend of the port against the reference's kernel run: the
    two backends agree to 2e-5, the reference's pallas≡gspmd
    tolerance."""
    ref = ref_runs["pallas"]
    got = _port(agg_mode=mode).run(device="cpu")
    _params_close(got.params, ref.params, TOL)
    assert _host(got.history) == _host(ref.history)
    assert got.stats == ref.stats
    assert got.staleness_hist == ref.staleness_hist
    np.testing.assert_allclose([m["loss"] for m in got.history],
                               [m["loss"] for m in ref.history], atol=TOL)
    assert got.stats["rej_replay"] + got.stats["rej_dup_client"] > 0
    assert any(m["staleness_max"] > 0 for m in got.history)


def _events(ring, names):
    return [(e["type"], e["name"], e.get("round"), e["value"])
            for e in ring.events if e.get("name") in names]


def test_sink_counters_and_occupancy_equal_reference(ref_runs):
    ring = RingSink()
    res = _port().run(device="cpu", sink=ring)
    names = ("accepted", "rej_replay", "rej_dup_client", "dropped",
             "crashed", "hung", "buffer_occupancy", "staleness_hist")
    assert _events(ring, names) == _events(ref_runs["ring"], names)
    occ = [e["value"] for e in ring.by_name("buffer_occupancy")]
    assert len(occ) == res.stats["rounds"]
    assert all(0.0 < v <= CHAOS["buffer_size"] for v in occ)
    # one span a fenced fire: every 8th by default, the first included
    assert [e["round"] for e in ring.by_name("fire")] == [0]
    assert [e["round"] for e in ring.by_type("round")] == \
        list(range(res.stats["rounds"]))
    d = res.to_dict()
    assert sum(res.staleness_hist.values()) == \
        res.stats["rounds"] * CHAOS["buffer_size"]
    assert d["staleness_hist"] == ref_runs["ring"].by_name(
        "staleness_hist")[0]["value"]


def test_traced_krum_equals_untraced_and_reference(ref_runs):
    spec = _port(aggregator="krum", bucket_size=0)
    plain = spec.run(device="cpu")
    traced = spec.replace(trace=True).run(device="cpu")
    _params_equal(plain.params, traced.params)
    assert [m["g_norm"] for m in plain.history] == \
        [m["g_norm"] for m in traced.history]
    ref = ref_runs["krum"]
    assert len(traced.traces) == len(ref.traces) == traced.stats["rounds"]
    for got, want in zip(traced.traces, ref.traces):
        assert got["byz_mask"] == want["byz_mask"]
        assert got["krum_selected"] == want["krum_selected"]
        np.testing.assert_allclose(got["influence"], want["influence"],
                                   rtol=0, atol=TOL)
    sums = [sum(t["influence"]) for t in traced.traces]
    assert max(sums) > 1.0 + 1e-4      # a stale pick weighs above 1
    for k in ("detect_precision", "detect_recall", "byz_leakage"):
        assert [m[k] for m in traced.history] == [m[k] for m in ref.history]
    assert traced.detection_summary()["rounds"] == len(traced.traces)
    assert plain.detection_summary() == {}


@pytest.mark.parametrize("mode", ["gspmd", "pallas"])
def test_sync_limit_is_the_synchronous_run(mode):
    spec = ServeSpec(**{**SYNC, "agg_mode": mode})
    res = spec.run(device="cpu")
    sync = spec.to_run_spec().run(device="cpu", log_every=1)
    _params_equal(res.params, sync.state["params"])
    assert [m["loss"] for m in res.history] == \
        [m["loss"] for m in sync.history]
    assert res.stats["rounds"] == 5
    assert all(m["staleness_max"] == 0 for m in res.history)
    if mode == "pallas":
        ref = JaxServeSpec(**{**SYNC, "agg_mode": mode}).build().run()
        _params_close(res.params, ref.params, SYNC_GAP)


def test_replay_is_bit_identical():
    spec = _port(agg_mode="gspmd")
    r1, r2 = spec.run(device="cpu"), spec.run(device="cpu")
    _params_equal(r1.params, r2.params)
    assert r1.history == r2.history


def test_dedup_makes_duplicate_deliveries_invisible():
    spec = _port()
    evs = [e.to_dict() for e in _take(spec.build("cpu").arrival_process(),
                                      200)]
    dup = spec.replace(arrival="trace", arrival_kwargs={"events": evs})
    clean = spec.replace(arrival="trace", arrival_kwargs={
        "events": [e for e in evs if not e["replay"]]})
    r_dup, r_clean = dup.run(device="cpu"), clean.run(device="cpu")
    assert r_dup.stats["rej_replay"] + r_dup.stats["rej_dup_client"] > 0
    assert r_clean.stats["rej_replay"] == 0
    _params_equal(r_dup.params, r_clean.params)


def _take(proc, n):
    out = []
    for ev in proc.events():
        out.append(ev)
        if len(out) >= n:
            break
    return out


def test_fault_labels_are_trajectory_invisible():
    spec = _port(arrival_kwargs=FAULTS)
    live = spec.run(device="cpu")
    assert live.stats["crashed"] > 0 and live.stats["hung"] > 0
    evs = _take(spec.build("cpu").arrival_process(), live.stats["events"])
    relabeled = [dataclasses.replace(e, dropped=e.dropped or e.crashed,
                                     crashed=False, hung=False).to_dict()
                 for e in evs]
    r_plain = spec.replace(arrival="trace",
                           arrival_kwargs={"events": relabeled}
                           ).run(device="cpu")
    _params_equal(live.params, r_plain.params)
    assert r_plain.stats["crashed"] == 0 and r_plain.stats["hung"] == 0
    assert r_plain.stats["dropped"] == \
        live.stats["dropped"] + live.stats["crashed"]


@pytest.mark.parametrize("arrival_kwargs", [None, FAULTS],
                         ids=["chaos", "faults"])
def test_kill_mid_buffer_and_resume_is_bit_identical(tmp_path,
                                                     arrival_kwargs):
    kw = {"rounds": 6}
    if arrival_kwargs is not None:
        kw["arrival_kwargs"] = arrival_kwargs
    spec = _port(**kw)
    lg_full = str(tmp_path / "full.jsonl")
    full = spec.run(device="cpu", ledger_path=lg_full, digest=True)
    ck, lg = str(tmp_path / "ck"), str(tmp_path / "resumed.jsonl")
    crash = spec.run(device="cpu", checkpoint=ck, checkpoint_every=2,
                     stop_after_events=25, digest=True, ledger_path=lg)
    assert crash.stats["rounds"] < 6
    resumed = spec.run(device="cpu", resume=ck, ledger_path=lg,
                       digest=True)
    assert resumed.stats == full.stats
    _params_equal(full.params, resumed.params)
    assert params_digest(resumed.params) == params_digest(full.params)
    from repro_torch.exec.ledger import Ledger
    want = {r["run_id"]: r["params_sha1"]
            for r in Ledger(lg_full).iter_records()}
    got = list(Ledger(lg).iter_records())
    assert len(got) >= 6
    for rec in got:
        assert rec["params_sha1"] == want[rec["run_id"]]


def test_reference_checkpoint_resumes_in_the_port(tmp_path, ref_runs):
    """The reference kills its run mid-buffer; the port resumes from the
    reference's checkpoint and ends at the reference's uninterrupted run
    (params to 2e-5; stats and host history equal)."""
    ck = str(tmp_path / "ck")
    crash = _ref().build().run(checkpoint=ck, checkpoint_every=2,
                               stop_after_events=20)
    assert 0 < crash.stats["rounds"] < CHAOS["rounds"]
    resumed = _port().run(device="cpu", resume=ck)
    full = ref_runs["pallas"]
    assert resumed.stats == full.stats
    assert _host(resumed.history) == \
        _host(full.history[len(full.history) - len(resumed.history):])
    _params_close(resumed.params, full.params, TOL)
    # the digest is the reference's on equal bytes
    assert params_digest(resumed.params) == \
        _ref_digest({k: resumed.params[k].numpy() for k in resumed.params})


def _ref_digest(params):
    from repro.serve import params_digest as jax_digest
    return jax_digest({k: jax.numpy.asarray(v) for k, v in params.items()})
