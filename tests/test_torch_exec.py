"""The port's sweep engine against the reference's: run ids, grouping and
batching answers, seed groups equal to serial runs bit for bit, the
ledger (torn lines, provenance, failure isolation), resume, and the
summary table."""
import json
import os

import pytest
import torch

from repro import exec as jax_xc
from repro.api import RunSpec as JaxRunSpec
from repro.api import Sweep as JaxSweep
from repro.api import registry as jax_registry
from repro_torch import exec as xc
from repro_torch.api import RunSpec, Sweep, registry, resolve_agg_mode, run
from repro_torch.exec import scheduler

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TRAJ_TOL = 2e-5
STEPS = 6
BASE = dict(task="logreg", method="marina", n_workers=5, n_byz=1, p=0.3,
            lr=0.25, attack="ALIE", aggregator="cm", bucket_size=2,
            steps=STEPS, data_kwargs={"n_samples": 60, "dim": 30,
                                      "batch_size": 8, "data_seed": 0})
CPU = {"log_every": 1, "device": "cpu"}
GRID = {"aggregator": ("mean", "cm"), "seed": (0, 1, 2)}


def _cells(grid=None, **kw):
    return list(Sweep(RunSpec(**{**BASE, **kw}), grid or GRID).expand())


def _jax_cells(grid=None, **kw):
    return list(JaxSweep(JaxRunSpec(**{**BASE, **kw}),
                         grid or GRID).expand())


def _history(h):
    return [{k: v for k, v in m.items() if k != "wall_s"} for m in h]


def _summary_bytes(out_dir):
    path = xc.write_summary(os.path.join(out_dir, "x_summary.json"),
                            xc.summarize_dir(out_dir))
    with open(path, "rb") as f:
        return f.read()


def test_sweep_ids_and_specs_are_the_references():
    grid = {"aggregator": ("mean", "cm"),
            "compressor_kwargs.ratio": (0.1, 0.5),
            "attack_kwargs.z": (None,), "seed": (0, 3)}
    kw = dict(compressor="randk", compressor_kwargs={"ratio": 1.0})
    got, want = _cells(grid, **kw), _jax_cells(grid, **kw)
    assert len(got) == len(want) == len(Sweep(RunSpec(**BASE), grid)) == 8
    for (rid, spec), (jrid, jspec) in zip(got, want):
        assert rid == jrid
        assert spec.to_json() == jspec.to_json()
    assert got[0][0] == ("aggregator=mean__compressor_kwargs.ratio=0.1__"
                         "attack_kwargs.z=None__seed=0")
    with pytest.raises(ValueError, match="not a RunSpec field"):
        Sweep(RunSpec(), {"nope": (1,)})


def test_registry_is_the_references():
    assert registry.kinds() == jax_registry.kinds()
    for kind in registry.kinds():
        assert registry.components(kind) == jax_registry.components(kind)
        assert registry.describe(kind) == jax_registry.describe(kind)
    for kind, name in (("aggregator", "krun"), ("method", "marnia"),
                       ("registry kind", "x")):
        with pytest.raises(ValueError) as err:
            (registry.check(kind, name) if kind != "registry kind"
             else registry.components(name))
        with pytest.raises(ValueError) as ref_err:
            (jax_registry.check(kind, name) if kind != "registry kind"
             else jax_registry.components(name))
        assert str(err.value) == str(ref_err.value)
    comp = registry.resolve("compressor", "randk", ratio=0.1)
    assert type(comp).__name__ == type(jax_registry.resolve(
        "compressor", "randk", ratio=0.1)).__name__
    assert registry.resolve("optimizer", "none") is None
    with pytest.raises(ValueError, match="did you mean 'krum'"):
        RunSpec(aggregator="krun")
    assert resolve_agg_mode("rfa") == "rfa"
    assert resolve_agg_mode("auto") == (
        "pallas" if torch.cuda.is_available() else "gspmd")
    with pytest.raises(ValueError, match="resolve_agg_mode"):
        RunSpec(agg_mode="auto")


def test_grouping_and_batching_answers_are_the_references():
    cases = {
        "groups": ({}, None),
        "one cell": ({}, slice(0, 1)),
        "pallas": ({"agg_mode": "pallas"}, None),
        "traced": ({"trace": True}, None),
        "saga": ({"method": "saga"}, None),
        "sparse": ({"compressor": "randk",
                    "compressor_kwargs": {"ratio": 0.5}}, None),
    }
    for what, (kw, cut) in cases.items():
        got = _cells({"seed": (0, 1, 2)}, **kw)
        want = _jax_cells({"seed": (0, 1, 2)}, **kw)
        if cut is not None:
            got, want = got[cut], want[cut]
        assert xc.can_batch(got) == jax_xc.can_batch(want), what
    got, want = _cells(), _jax_cells()
    g_groups, j_groups = xc.group_cells(got), jax_xc.group_cells(want)
    assert ([(k, [r for r, _ in m]) for k, m in g_groups]
            == [(k, [r for r, _ in m]) for k, m in j_groups])
    for (_, members), (_, jmembers) in zip(g_groups, j_groups):
        assert xc.can_batch(members) == jax_xc.can_batch(jmembers) is True
    mixed = [got[0], (got[1][0], got[1][1].replace(lr=0.1))]
    jmixed = [want[0], (want[1][0], want[1][1].replace(lr=0.1))]
    assert xc.can_batch(mixed) == jax_xc.can_batch(jmixed) is False
    same_seed = [got[0], got[0]]
    assert xc.can_batch(same_seed) == jax_xc.can_batch(
        [want[0], want[0]]) is False
    members = g_groups[0][1]
    assert xc.can_batch(members, {"log_every": 1, "warmup": True})
    assert xc.can_batch(members, {"device": "cpu"})   # the port's knob
    assert not xc.can_batch(members, {"callback": print})
    assert not jax_xc.can_batch(j_groups[0][1], {"callback": print})


def test_run_group_equals_serial_runs_bit_for_bit():
    cells = _cells({"seed": (0, 1, 2)}, compressor="randk",
                   compressor_kwargs={"ratio": 0.5})
    results, stats = xc.run_group(cells, log_every=1, device="cpu")
    assert stats["group_size"] == 3 and stats["step_compiles"] == 0
    for run_id, spec in cells:
        serial = run(spec, device="cpu", log_every=1)
        got = results[run_id]
        assert got.spec == spec
        assert _history(got.history) == _history(serial.history)
        assert got.comm_bits == serial.comm_bits
        for k in ("params", "g"):
            for n in serial.state[k]:
                assert torch.equal(got.state[k][n], serial.state[k][n])
    with pytest.raises(ValueError, match="batchable"):
        xc.run_group(cells[:1], device="cpu")


def test_killed_and_resumed_sweep_summary_has_the_same_bytes(tmp_path):
    cells = _cells(steps=3)
    d1, d2 = str(tmp_path / "full"), str(tmp_path / "killed")
    full = xc.run_cells(cells, out_dir=d1, run_kw=CPU)
    assert full.stats["seed_groups"] == 2 and not full.failures
    # "kill" after 4 of 6 cells: the first group committed, the second
    # torn mid-group
    xc.run_cells(cells[:4], out_dir=d2, run_kw=CPU)
    srun = xc.run_cells(cells, out_dir=d2, resume=True, run_kw=CPU)
    # the finished group was skipped; the torn group re-ran whole
    assert len(srun.skipped) == 3
    assert srun.stats["executed_cells"] == 3
    assert _summary_bytes(d1) == _summary_bytes(d2)
    # serial cells commit one by one
    serial = _cells({"aggregator": ("mean", "cm")}, steps=3)
    d3 = str(tmp_path / "serial")
    xc.run_cells(serial[:1], out_dir=d3, run_kw=CPU)
    srun = xc.run_cells(serial, out_dir=d3, resume=True, run_kw=CPU)
    assert srun.skipped == {serial[0][0]}
    assert srun.stats["executed_cells"] == 1 and len(srun) == 2


def test_ledger_heals_a_torn_line(tmp_path):
    led = xc.Ledger(str(tmp_path / "ledger.jsonl"))
    led.append("a", "started", spec={"seed": 0})
    led.append("a", "done", wall_s=1.5)
    with open(led.path, "a") as f:
        f.write('{"run_id": "b", "status": "do')     # killed mid-write
    assert led.completed() == {"a"}
    led.append("b", "done")                          # on a fresh line
    led.append("c", "failed", error="ValueError: boom")
    assert led.completed() == {"a", "b"}
    assert led.failed() == {"c"}
    assert led.record("a")["wall_s"] == 1.5
    assert [r["run_id"] for r in led.iter_records()] == ["a", "a", "b",
                                                         "c"]
    with open(led.path) as f:
        lines = f.read().splitlines()
    assert len(lines) == 5 and lines[2].endswith('"do')


def test_ledger_records_provenance(tmp_path):
    cells = _cells({"seed": (0,)})
    xc.run_cells(cells, out_dir=str(tmp_path), run_kw=CPU)
    recs = list(xc.Ledger(str(tmp_path / "ledger.jsonl")).iter_records())
    assert [r["status"] for r in recs] == ["started", "done"]
    assert recs[0]["spec"] == cells[0][1].to_dict()
    for rec in recs:
        assert rec["git_sha"]
        assert rec["device_kind"] == "cpu:1"
        assert rec["engine"] == "serial"
    assert recs[1]["wall_s"] > 0
    assert xc.device_kind("cpu") == "cpu:1"
    assert xc.device_kind().startswith("cuda:")


def test_failure_isolation_records_and_continues(tmp_path, monkeypatch):
    cells = _cells({"aggregator": ("mean", "cm")})
    real_run = scheduler.run_spec

    def boom(spec, **kw):
        if spec.aggregator == "mean":
            raise RuntimeError("diverged")
        return real_run(spec, **kw)

    monkeypatch.setattr(scheduler, "run_spec", boom)
    srun = xc.run_cells(cells, out_dir=str(tmp_path), run_kw=CPU)
    assert set(srun.failures) == {cells[0][0]}
    assert "diverged" in srun.failures[cells[0][0]]["error"]
    assert cells[1][0] in srun                         # grid kept going
    led = xc.Ledger(str(tmp_path / "ledger.jsonl"))
    assert led.failed() == {cells[0][0]}
    assert led.completed() == {cells[1][0]}


def test_a_cell_without_a_card_fails_rather_than_moving(tmp_path):
    cells = _cells({"seed": (0,)})
    srun = xc.run_cells(cells, out_dir=str(tmp_path), run_kw={})
    if torch.cuda.is_available():
        assert not srun.failures
    else:
        assert "CUDA" in srun.failures[cells[0][0]]["error"]


def test_summary_matches_the_references(tmp_path):
    grid = {"aggregator": ("mean", "cm"), "seed": (0, 1)}
    srun = xc.run_cells(_cells(grid), out_dir=str(tmp_path), run_kw=CPU)
    got = xc.summarize(srun.artifacts)
    want = jax_xc.summarize(jax_xc.run_cells(
        _jax_cells(grid), run_kw={"log_every": 1}).artifacts)
    assert got["n_cells"] == want["n_cells"] == 4
    assert [g["label"] for g in got["groups"]] == \
        [g["label"] for g in want["groups"]] == ["aggregator=cm",
                                                 "aggregator=mean"]
    assert got["best"]["label"] == want["best"]["label"]
    for g, w in zip(got["groups"], want["groups"]):
        assert g["spec"] == w["spec"] and g["run_ids"] == w["run_ids"]
        assert sorted(g["final"]) == sorted(w["final"])
        for name, stat in w["final"].items():
            assert abs(g["final"][name]["mean"] - stat["mean"]) <= \
                TRAJ_TOL * max(1.0, abs(stat["mean"])), name
    assert json.dumps(got, sort_keys=True) == json.dumps(
        xc.summarize_dir(str(tmp_path)), sort_keys=True)
