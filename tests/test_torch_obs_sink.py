"""The host side of the observability layer: ``obs.detect`` equal to the
reference's on hand-built traces, the ``MetricSink`` protocol,
``verify_jsonl`` failing closed as the reference's does, the runner's
round / trace / span / gauge events through a ``JsonlSink`` (and the
``python -m repro_torch.obs.sink --verify`` gate on them), and
``profile_trace`` writing a Chrome trace with one ``round`` range a round.
No reference run is needed here.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.obs import detect as jax_detect
from repro.obs import sink as jax_sink
from repro_torch.api import RunSpec, run
from repro_torch.obs import detect, profile
from repro_torch.obs.sink import (FanoutSink, JsonlSink, NullSink, RingSink,
                                  TagSink, span, verify_jsonl)
from repro_torch.obs.sink import _main as sink_main

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TRACES = [
    {"influence": [0.0, 0.05, 0.475, 0.475],
     "byz_mask": [True, True, False, False]},
    {"influence": [0.3, 0.05, 0.35, 0.3],
     "byz_mask": [True, False, False, False]},
    {"influence": [0.5, 0.5], "byz_mask": [False, False]},
    {"influence": [0.0, 0.0, 0.5, 0.5], "byz_mask": [False, True, False,
                                                     False],
     "fault_mask": [True, False, False, True],
     "guard_valid": [False, True, True, True]},
    {"influence": [0.25, 0.25, 0.0, 0.5], "byz_mask": [True, False, False,
                                                       False],
     "fault_mask": [False, False, True, False],
     "guard_valid": [True, True, False, True]},
]


@pytest.mark.parametrize("i", range(len(TRACES)))
def test_detection_equals_the_reference(i):
    t = TRACES[i]
    for frac in (0.5, 0.1, 1.0):
        assert (detect.detection_metrics(t, frac)
                == jax_detect.detection_metrics(t, frac))
        assert (detect.filtered_mask(t, frac).tolist()
                == jax_detect.filtered_mask(t, frac).tolist())
    assert detect.fault_metrics(t) == jax_detect.fault_metrics(t)


def test_summary_equals_the_reference():
    assert detect.summarize(TRACES) == jax_detect.summarize(TRACES)
    assert detect.summarize(TRACES[:3], 0.2) == jax_detect.summarize(
        TRACES[:3], 0.2)
    assert detect.summarize([]) == jax_detect.summarize([]) == {}


def test_sink_protocol(tmp_path):
    ring = RingSink(capacity=3)
    tagged = TagSink(ring, run_id="r1")
    path = tmp_path / "m.jsonl"
    js = JsonlSink(str(path))
    fan = FanoutSink(tagged, js, None, NullSink())
    for i in range(5):
        fan.emit({"type": "round", "step": i, "loss": 1.0 / (i + 1)})
    with span(fan, "phase", rounds=5):
        pass
    fan.close()
    assert len(ring.events) == 3                       # the last three
    assert [e["step"] for e in ring.by_type("round")] == [3, 4]
    assert all(e["run_id"] == "r1" for e in ring.events)
    sp = ring.by_name("phase")[0]
    assert sp["type"] == "span" and sp["rounds"] == 5 and sp["wall_s"] >= 0
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [e["type"] for e in lines] == ["round"] * 5 + ["span"]
    assert verify_jsonl(str(path)) == {"round": 5, "span": 1}


_STREAMS = {
    "ok": [{"type": "round", "loss": 0.5},
           {"type": "trace", "influence": [0.5, 0.5]}],
    "empty": [],
    "nan round": [{"type": "round", "loss": float("nan")}],
    "inf trace": [{"type": "trace", "influence": [0.5, float("inf")]}],
    # a chaos trace may carry the guard's +inf Krum score
    "chaos carve-out": [{"type": "trace", "krum_scores": [1.0, float("inf")],
                         "guard_valid": [True, False]}],
    "chaos round stays strict": [{"type": "round", "loss": float("inf"),
                                  "guard_valid": [True]}],
    "fault ok": [{"type": "fault", "kind": "nan_grad", "site": "tensor"}],
    "fault kind": [{"type": "fault", "kind": "gremlins", "site": "tensor"}],
    "fault site": [{"type": "fault", "kind": "nan_grad", "site": "disk"}],
}


@pytest.mark.parametrize("name", sorted(_STREAMS))
def test_verify_jsonl_fails_closed_as_the_reference(tmp_path, name):
    path = tmp_path / "s.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in _STREAMS[name]))
    outcomes = []
    for fn in (verify_jsonl, jax_sink.verify_jsonl):
        try:
            outcomes.append(("ok", fn(str(path))))
        except ValueError as err:
            outcomes.append(("raised", str(err)))
    assert outcomes[0] == outcomes[1]
    bad = name in ("empty", "nan round", "inf trace",
                   "chaos round stays strict", "fault kind", "fault site")
    assert outcomes[0][0] == ("raised" if bad else "ok")


def test_verify_jsonl_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        verify_jsonl(str(tmp_path / "absent.jsonl"))


SPEC = dict(n_workers=5, n_byz=1, attack="ALIE", aggregator="krum",
            bucket_size=2, agg_mode="pallas", compressor="randk",
            compressor_kwargs={"ratio": 0.1}, steps=6, trace=True,
            data_kwargs={"dim": 8, "n_samples": 40, "batch_size": 4})


def test_runner_emits_rounds_traces_and_detection(tmp_path):
    ring = RingSink()
    path = str(tmp_path / "run.jsonl")
    res = run(RunSpec(**SPEC), device="cpu", log_every=2, sink=ring,
              metrics_jsonl=path)
    rounds = ring.by_type("round")
    assert [e["step"] for e in rounds] == [0, 2, 4, 5]
    assert all("detect_precision" in e and "byz_leakage" in e
               for e in rounds)
    tr = ring.by_type("trace")
    assert [e["step"] for e in tr] == [0, 2, 4, 5] and len(res.traces) == 4
    assert all(len(e["influence"]) == 5 and e["rule"] == "krum"
               for e in tr)
    assert ring.by_name("run")[0]["type"] == "span"
    det = ring.by_name("detection_summary")[0]
    assert det["type"] == "gauge"
    assert det["value"] == res.detection_summary()
    assert det["value"]["rounds"] == 4
    assert all(math.isfinite(v) for v in (det["value"]["precision"],
                                          det["value"]["recall"]))
    counts = verify_jsonl(path)
    assert counts == {"round": 4, "trace": 4, "span": 1, "gauge": 1}
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.sink",
                          "--verify", path], capture_output=True, text=True,
                         env=env, check=True)
    assert "10 events ok" in out.stdout
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty"):
        sink_main(["--verify", str(empty)])


def test_profile_trace_writes_round_ranges(tmp_path):
    with profile.profile_trace(None) as prof:
        assert prof is None
    profile.enable_step_markers()
    try:
        with profile.profile_trace(str(tmp_path / "prof")):
            run(RunSpec(**{**SPEC, "steps": 3}), device="cpu")
    finally:
        profile.enable_step_markers(False)
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    rounds = [e for e in events if e.get("name") == profile.ROUND_RANGE
              and e.get("ph") == "X"]
    assert len(rounds) == 3
    assert sum(e.get("name", "").startswith("aten::") for e in events) > 100
