"""The runner's loop knobs: checkpoint and resume (bit for bit within the
port, and from a reference checkpoint to the reference's trajectory),
the warm-up step, the callback and ``metrics_out``."""
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import run as jax_run
from repro_torch.api import RunSpec, run
from repro_torch.core.estimators import ESTIMATORS

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TRAJ_TOL = 2e-5
STEPS = 10
KILL_AT = 5
BASE = dict(n_workers=5, n_byz=1, attack="ALIE", aggregator="cm",
            bucket_size=2, agg_mode="pallas", compressor="randk",
            compressor_kwargs={"ratio": 0.5}, p=0.3, lr=0.25, steps=STEPS,
            seed=1, data_kwargs={"dim": 30, "n_samples": 60,
                                 "batch_size": 8})
_METHOD_KW = {"svrg": {"aggregator": "rfa"},
              "saga": {"method_kwargs": {"batch_size": 8}},
              "byz_ef21": {"compressor": "topk"},
              "cmfilter": {"compressor": "topk", "aggregator": "krum"}}


def _spec(method="marina", **kw):
    return RunSpec(**{**BASE, "method": method,
                      **_METHOD_KW.get(method, {}), **kw})


def _history(res):
    return [{k: v for k, v in h.items() if k != "wall_s"}
            for h in res.history]


def _same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            assert sorted(a[k]) == sorted(b[k]), k
            for n in a[k]:
                assert torch.equal(a[k][n], b[k][n]), (k, n)
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("method", ["marina", "saga", "diana", "svrg",
                                    "byz_ef21"])
def test_resume_equals_the_uninterrupted_run(method, tmp_path):
    spec = _spec(method)
    full = run(spec, device="cpu", log_every=1)
    ck = str(tmp_path / "ck")
    run(spec.replace(steps=KILL_AT), device="cpu", log_every=1,
        checkpoint=ck)
    resumed = run(spec, device="cpu", log_every=1, resume=ck)
    # every state entry crosses the checkpoint: saga's tables, byz_ef21's
    # worker_g, diana's shifts and alpha, svrg's snapshot
    _same_state(resumed.state, full.state)
    assert resumed.state["step"] == STEPS
    assert [h["step"] for h in resumed.history] == list(range(KILL_AT,
                                                              STEPS))
    tail = _history(full)[KILL_AT:]
    base = full.history[KILL_AT - 1]["comm_bits"]
    for h in tail:
        h["comm_bits"] -= base
        h["comm_gbits"] = round(h["comm_bits"] / 1e9, 4)
    assert _history(resumed) == tail
    assert resumed.comm_bits == full.comm_bits - base


def test_periodic_checkpoint_then_resume(tmp_path):
    spec = _spec()
    ck = str(tmp_path / "ck")
    marks = []
    run(spec.replace(steps=KILL_AT + 1), device="cpu", log_every=1,
        checkpoint=ck, checkpoint_every=2,
        callback=lambda it, state, m: marks.append(
            json.loads((tmp_path / "ck.json").read_text())["step"]
            if (tmp_path / "ck.json").exists() else None),
        callback_every=1)
    # written after rounds 2 and 4, and at the end (6) over the last one
    assert marks == [None, None, 2, 2, 4, 4]
    assert json.loads((tmp_path / "ck.json").read_text())["step"] == 6
    resumed = run(spec, device="cpu", log_every=1, resume=ck)
    full = run(spec, device="cpu", log_every=1)
    _same_state(resumed.state, full.state)
    assert resumed.history[0]["step"] == KILL_AT + 1


@pytest.fixture(scope="module")
def reference_resume(tmp_path_factory):
    """The reference's uninterrupted run (gspmd: its pallas backend runs
    in interpret mode on the CPU) and its checkpoint at KILL_AT, written
    by ``checkpoint_every`` after round KILL_AT - 1 and copied aside by
    the next round's callback, before the run writes over it."""
    out = tmp_path_factory.mktemp("ref")

    def keep(it, state, m):
        if it == KILL_AT:
            for ext in (".npz", ".json"):
                shutil.copy(out / f"ck{ext}", out / f"at{KILL_AT}{ext}")

    ref = jax_run(JaxRunSpec(**{**BASE, "method": "marina",
                                "agg_mode": "gspmd"}),
                  log_every=1, checkpoint=str(out / "ck"),
                  checkpoint_every=KILL_AT, callback=keep)
    return str(out / f"at{KILL_AT}"), ref


def test_resume_from_a_reference_checkpoint(reference_resume):
    ck, ref = reference_resume
    got = run(_spec(agg_mode="gspmd"), device="cpu", log_every=1, resume=ck)
    want = ref.history[KILL_AT:]
    assert [h["step"] for h in got.history] == [h["step"] for h in want]
    assert [h["c_k"] for h in got.history] == [h["c_k"] for h in want]
    ck_after = [h["c_k"] for h in want]
    assert 1.0 in ck_after and 0.0 in ck_after     # both round kinds
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in want],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for k in ("params", "g"):
        for n, t in got.state[k].items():
            np.testing.assert_allclose(
                t.numpy(), np.asarray(jax.device_get(ref.state[k][n])),
                rtol=TRAJ_TOL, atol=TRAJ_TOL)
    assert got.state["step"] == int(ref.state["step"]) == STEPS
    assert json.loads(Path(ck + ".json").read_text())["step"] == KILL_AT


def test_run_result_keys_are_the_references(reference_resume, tmp_path):
    _, ref = reference_resume
    path = tmp_path / "m.json"
    got = run(_spec(agg_mode="gspmd"), device="cpu", log_every=1,
              metrics_out=str(path))
    assert json.loads(path.read_text()) == got.to_dict()
    assert sorted(got.to_dict()) == sorted(ref.to_dict())
    assert got.to_dict()["spec"] == ref.spec.to_dict()
    assert [sorted(h) for h in got.history] == \
        [sorted(h) for h in ref.history]


def test_traced_metrics_out_carries_detection(tmp_path):
    path = tmp_path / "m.json"
    got = run(_spec(trace=True, steps=3), device="cpu", log_every=1,
              metrics_out=str(path))
    payload = json.loads(path.read_text())
    assert payload == json.loads(json.dumps(got.to_dict()))
    assert payload["detection"] == got.detection_summary()


@pytest.mark.parametrize("method", sorted(ESTIMATORS))
def test_warmup_leaves_the_trajectory(method):
    spec = _spec(method, steps=4)
    plain = run(spec, device="cpu", log_every=1)
    warm = run(spec, device="cpu", log_every=1, warmup=True)
    assert _history(warm) == _history(plain)
    _same_state(warm.state, plain.state)


def test_callback_stops_early_and_records_the_stop():
    spec = _spec()
    seen = []

    def stop_at_5(it, state, m):
        seen.append(it)
        return it == 5

    got = run(spec, device="cpu", log_every=4, callback=stop_at_5,
              callback_every=2)
    # called every second round; the stop at 5 is recorded beside the
    # log steps 0 and 4
    assert seen == [1, 3, 5]
    assert [h["step"] for h in got.history] == [0, 4, 5]
    short = run(spec.replace(steps=6), device="cpu", log_every=1)
    _same_state(got.state, short.state)
    assert got.history[-1]["loss"] == short.history[-1]["loss"]
    assert got.comm_bits == short.comm_bits


def test_callback_defaults_to_the_log_steps():
    seen = []
    run(_spec(steps=7), device="cpu", log_every=3,
        callback=lambda it, state, m: seen.append((it, m["step"])))
    assert seen == [(0, 0), (3, 3), (6, 6)]
