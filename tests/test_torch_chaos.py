"""The chaos driver (``repro_torch.launch.chaos``) against the reference's
(``repro.launch.chaos``) on the CPU, at the ``--smoke`` grid and the
CLI's defaults (12 workers, 2 Byzantine, 2 faulty, 8 rounds).

The port's ``main`` exits 0 with a GREEN report, and its metric stream
passes both packages' ``verify_jsonl``. Each cell of its report is held
to the reference's ``run_cell(cell_spec(...))`` on the same cell: final
loss within CELL_TOL relative (the trajectory tolerance of ROADMAP
queue 3), ``finite``, ``fault_recall`` and ``fault_precision`` equal.
The guard-off control goes non-finite in both.
"""
from __future__ import annotations

import json
import math

import pytest
import torch

from repro.launch import chaos as jax_chaos
from repro.obs.sink import verify_jsonl as jax_verify_jsonl
from repro_torch.launch import chaos
from repro_torch.obs.sink import verify_jsonl

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

CELL_TOL = 2e-5
CFG = dict(n_workers=12, n_byz=2, n_faulty=2, steps=8, seed=0)
SMOKE_CELLS = [(kind, rule, backend)
               for kind in ("nan_grad", "stale_replay", "corrupt_wire")
               for rule in ("cm", "rfa")
               for backend in ("gspmd", "pallas")
               if kind != "corrupt_wire" or backend == "pallas"]


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("chaos")
    rc = chaos.main(["--smoke", "--device", "cpu", "--out-dir", str(out)])
    report = json.loads((out / "fault_report.json").read_text())
    return rc, report, out / "chaos_metrics.jsonl"


def test_smoke_is_green_and_its_stream_verifies(smoke):
    rc, report, stream = smoke
    assert rc == 0 and report["green"]
    assert report["device"] == "cpu"
    assert len(report["cells"]) == len(SMOKE_CELLS)
    assert report["control_guard_off_nonfinite"]
    assert all(p["close"] for p in report["cross_backend_parity"])
    counts = verify_jsonl(str(stream))
    assert counts == jax_verify_jsonl(str(stream))
    assert counts["fault"] == len(SMOKE_CELLS) and counts["trace"] > 0


@pytest.mark.parametrize("kind,rule,backend", SMOKE_CELLS)
def test_cell_matches_reference(smoke, kind, rule, backend):
    _, report, _ = smoke
    got = next(c for c in report["cells"] if (c["kind"], c["rule"],
                                              c["backend"])
               == (kind, rule, backend))
    want = jax_chaos.run_cell(
        jax_chaos.cell_spec(rule, backend, kind, **CFG), kind, log_every=2)
    assert got["ok"] and want["ok"]
    for k in ("finite", "fault_recall", "fault_precision", "rounds_traced"):
        assert got[k] == want[k], k
    a, b = got["final_loss"], want["final_loss"]
    assert abs(a - b) <= CELL_TOL * max(abs(b), 1e-12), (a, b)


def test_guard_off_control_goes_non_finite_in_both():
    runs = [mod.cell_spec("mean", "gspmd", "nan_grad", guard=False, **CFG)
            for mod in (chaos, jax_chaos)]
    port = runs[0].run("cpu", log_every=CFG["steps"], warmup=True)
    ref = runs[1].run(log_every=CFG["steps"], warmup=True)
    assert not math.isfinite(port.history[-1]["loss"])
    assert not math.isfinite(ref.history[-1]["loss"])


def test_budget_outside_the_guard_is_refused(tmp_path):
    with pytest.raises(SystemExit):
        chaos.main(["--n-workers", "8", "--n-byz", "2", "--n-faulty", "2",
                    "--device", "cpu", "--out-dir", str(tmp_path)])
