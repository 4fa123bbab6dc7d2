"""The worker pool and the sweep CLI: subprocess cells on the CPU, an
injected crash and hang retried to artifacts equal to in-process runs,
and ``python -m repro_torch.launch.sweep`` against the reference CLI."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch import sweep as jax_sweep_cli
from repro_torch import exec as xc
from repro_torch.api import RunSpec, Sweep, run
from repro_torch.faults import as_plan
from repro_torch.launch import sweep as sweep_cli

SRC = str(Path(__file__).resolve().parents[1] / "src")
BASE_KW = dict(task="logreg", method="marina", n_workers=5, n_byz=1, p=0.3,
               lr=0.25, attack="ALIE", aggregator="cm", bucket_size=2,
               steps=4,
               data_kwargs={"n_samples": 60, "dim": 30, "batch_size": 8})
GRID = '{"aggregator": ["mean", "cm"]}'


def _history(h):
    return [{k: v for k, v in m.items() if k != "wall_s"} for m in h]


@pytest.fixture(scope="module")
def faulted_sweep(tmp_path_factory):
    """Two cells through a two-worker pool on the CPU: the first attempt
    of cell 0 crashes, that of cell 1 hangs until a 1 s timeout reaps
    it."""
    out = tmp_path_factory.mktemp("pool")
    cells = list(Sweep(RunSpec(**BASE_KW),
                       {"aggregator": ("mean", "cm")}).expand())
    plan = as_plan({"seed": 0, "faults": [
        {"kind": "crash", "workers": [0]}, {"kind": "hang", "workers": [1]}]})
    pool = xc.WorkerPool(max_workers=2, fault_plan=plan, hang_timeout_s=1.0,
                         backoff_s=0.0)
    srun = xc.run_cells(cells, out_dir=str(out), pool=pool, batch=False,
                        run_kw={"log_every": 1, "device": "cpu"})
    records = {r["run_id"]: r for r in
               xc.Ledger(str(out / "ledger.jsonl")).iter_records()
               if r["status"] == "done"}
    return cells, srun, records, out


def test_pool_runs_subprocess_cells(faulted_sweep):
    cells, srun, records, out = faulted_sweep
    assert not srun.failures
    assert srun.stats["subprocess_cells"] == 2
    assert srun.stats["retried_cells"] == 2
    for rid, spec in cells:
        assert srun[rid].spec == spec                 # a CompletedCell
        assert (out / f"{rid}.json").exists()
        rec = records[rid]
        assert rec["engine"] == "subprocess" and rec["attempts"] == 2
        assert rec["device_kind"] == "cpu:1"
        timing = rec["worker_timing"]
        assert 0 < timing["loop_s"] <= timing["run_s"] < timing["total_s"]
        assert rec["wall_s"] >= timing["total_s"]


@pytest.mark.parametrize("cell,fault", [(0, "crash"), (1, "hang")])
def test_faulted_cell_is_retried_to_the_fault_free_artifact(
        faulted_sweep, cell, fault):
    cells, srun, records, _ = faulted_sweep
    rid, spec = cells[cell]
    rec = records[rid]
    assert rec["injected_fault"] == fault
    first = rec["attempt_history"][0]
    if fault == "crash":
        assert first["error"] == "worker-failed"
        assert first["returncode"] == 137
    else:
        assert first["error"] == "timeout"          # reaped, not waited on
    here = run(spec, device="cpu", log_every=1).to_dict()
    payload = srun.artifacts[rid]
    assert sorted(payload) == sorted(here)
    assert _history(payload["history"]) == _history(here["history"])
    assert payload["spec"] == here["spec"]
    assert payload["comm_bits"] == here["comm_bits"]


def test_injected_faults_act_before_torch_is_imported(tmp_path):
    code = ("import sys; from repro_torch.exec import worker; "
            "rc = worker.main(['--spec', 'x', '--out', 'y', '--fault', "
            "'crash']); print(rc, 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.stdout.split() == ["137", "False"]


def _base_path(tmp_path):
    path = tmp_path / "base.json"
    path.write_text(RunSpec(**BASE_KW).to_json())
    return str(path)


def test_cli_list_prints_the_reference_ids(tmp_path, capsys):
    args = ["--base", _base_path(tmp_path), "--grid", GRID,
            "--set", "compressor_kwargs.ratio=0.5", "--seeds", "0:2",
            "--list"]
    assert jax_sweep_cli.main(args) is None
    want = capsys.readouterr().out.strip().splitlines()
    assert sweep_cli.main(args) is None
    got = capsys.readouterr().out.strip().splitlines()
    assert got == want and len(got) == 4
    assert "aggregator=mean__seed=0" in got


def test_cli_runs_the_grid_and_writes_the_summary(tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_ART_DIR", str(tmp_path / "bench"))
    out_dir = tmp_path / "cells"
    args = ["--base", _base_path(tmp_path), "--grid", GRID,
            "--seeds", "0:2", "--out-dir", str(out_dir), "--name", "clitest",
            "--log-every", "2", "--device", "cpu",
            "--metrics-out-jsonl", str(tmp_path / "events.jsonl")]
    summary = sweep_cli.main(args)
    assert summary["n_cells"] == 4 and summary["n_groups"] == 2
    assert (out_dir / "ledger.jsonl").exists()
    with open(out_dir / "clitest_summary.json") as f:
        assert json.load(f) == summary
    with open(tmp_path / "bench" / "clitest_summary.json") as f:
        assert json.load(f) == summary
    events = [json.loads(line) for line in
              (tmp_path / "events.jsonl").read_text().splitlines()]
    assert {e["name"] for e in events if e["type"] == "gauge"} >= {
        "sweep_seed_groups", "sweep_executed_cells"}
    # resume: everything skips, the summary has the same bytes
    before = (out_dir / "clitest_summary.json").read_bytes()
    summary2 = sweep_cli.main(args + ["--resume"])
    assert summary2 == summary
    assert (out_dir / "clitest_summary.json").read_bytes() == before


def test_cli_set_overrides_and_seed_parsing():
    args = sweep_cli.build_parser().parse_args(
        ["--set", "lr=0.1", "--set", "attack=BF", "--set", "agg_mode=auto",
         "--set", "data_kwargs.dim=8", "--seeds", "0,2,5",
         "--device", "cpu"])
    sweep = sweep_cli.sweep_from_args(args)
    assert sweep.base.lr == 0.1 and sweep.base.attack == "BF"
    assert sweep.base.agg_mode in ("pallas", "gspmd")
    assert sweep.base.data_kwargs["dim"] == 8
    assert sweep.grid["seed"] == (0, 2, 5)
    assert args.device == "cpu"
