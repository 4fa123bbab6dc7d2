"""Sweep-execution orchestrator and subprocess worker pool (port of
``repro/exec/scheduler.py``).

``run_cells`` owns sweep execution end to end: it partitions cells into
seed groups (``exec/batching.py``), runs each batchable group in process
over one experiment, shards the other cells across a bounded subprocess
pool (``CUDA_VISIBLE_DEVICES`` pinned per worker, a per-cell timeout,
retries, failure isolation — one diverging attack cell records
``failed`` in the ledger and the grid keeps going), journals every cell
in the crash-safe ledger (``exec/ledger.py``), and writes one artifact
JSON per cell (``RunResult.to_dict()``) atomically.

A cell's device travels in ``run_kw["device"]``, so in-process, grouped
and subprocess cells all honour it; with none, a cell runs on the card
and raises where there is none. Nothing falls back to the CPU.

Resume semantics (``resume=True``): cells whose last ledger record is
``done`` AND whose artifact exists are loaded, not re-run; ``started`` /
``failed`` cells re-run. Serial and subprocess cells commit one by one;
a seed group commits atomically, and if ANY member is missing the WHOLE
group re-runs, as in the reference. Either way a killed-and-resumed
sweep equals an uninterrupted one bit for bit.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, Mapping, Optional, Sequence, Tuple

from repro_torch.api.runner import RunResult, build
from repro_torch.api.runner import run as run_spec
from repro_torch.api.spec import RunSpec
from repro_torch.exec import batching
from repro_torch.exec.ledger import Ledger, device_kind, git_sha
from repro_torch.obs.sink import TagSink
from repro_torch.obs.sink import span as obs_span


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompletedCell:
    """A cell loaded from a prior artifact (resume) or a worker subprocess —
    history and spec are available; live device state is not."""
    run_id: str
    payload: dict

    @property
    def history(self) -> list:
        return self.payload.get("history", [])

    @property
    def final(self) -> dict:
        return self.history[-1] if self.history else {}

    @property
    def spec(self) -> RunSpec:
        return RunSpec.from_dict(self.payload["spec"])

    def to_dict(self) -> dict:
        return self.payload


class SweepRun(Mapping):
    """The outcome of ``run_cells`` — a mapping ``run_id -> result``.

    Values are live ``RunResult``s for cells run in-process this call and
    ``CompletedCell``s for cells loaded from artifacts (resume / worker
    subprocesses); both expose ``history`` / ``final`` / ``to_dict()``.
    ``artifacts`` holds every completed cell's JSON payload (what
    ``exec.aggregate`` folds into summaries), ``failures`` the per-cell
    failure records, and ``stats`` the engine accounting.
    """

    def __init__(self):
        self.results: dict = {}          # run_id -> RunResult (in-process)
        self.artifacts: dict = {}        # run_id -> payload dict
        self.failures: dict = {}         # run_id -> failure record
        self.skipped: set = set()        # resumed, loaded from artifacts
        self.stats: dict = {"n_cells": 0, "executed_cells": 0,
                            "seed_groups": 0, "serial_cells": 0,
                            "subprocess_cells": 0}

    def __getitem__(self, run_id):
        if run_id in self.results:
            return self.results[run_id]
        if run_id in self.artifacts:
            return CompletedCell(run_id, self.artifacts[run_id])
        raise KeyError(run_id)

    def __iter__(self):
        seen = set(self.results)
        yield from self.results
        for rid in self.artifacts:
            if rid not in seen:
                yield rid

    def __len__(self):
        return len(set(self.results) | set(self.artifacts))


# ---------------------------------------------------------------------------
# subprocess worker pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkerPool:
    """Bounded local pool of subprocess workers for un-batchable cells.

    Each worker is a fresh ``python -m repro_torch.exec.worker`` process,
    so the card is pinned before torch initializes CUDA: ``gpu_ids``
    round-robins ``CUDA_VISIBLE_DEVICES`` across workers (the slot a cell
    draws is its id). The cell's device is ``run_kw["device"]``.
    ``timeout_s`` bounds each cell attempt; a crashed or timed-out attempt
    is retried up to ``max_retries`` times on a FRESH slot (the failed
    slot goes back to the queue), with ``backoff_s · 2^attempt`` sleep
    between attempts and the per-attempt timeout growing by
    ``timeout_escalation``× each retry (a cell that legitimately needs
    more time eventually gets it; a hung worker is reaped each round).
    Only a cell that fails every attempt records ``failed`` — with the
    final returncode, the stderr tail and the full per-attempt history —
    and the rest of the grid proceeds.

    ``fault_plan`` (``repro_torch.faults``) injects process-site chaos:
    cells selected by the plan's crash/hang specs get ``--fault`` on their
    FIRST attempt only, so with retries enabled the sweep completes with
    artifacts equal to a fault-free run's.
    """
    max_workers: int = 2
    timeout_s: Optional[float] = None
    gpu_ids: Optional[Sequence[str]] = None
    extra_env: Mapping = dataclasses.field(default_factory=dict)
    max_retries: int = 2
    backoff_s: float = 0.25
    timeout_escalation: float = 2.0
    fault_plan: Optional[object] = None     # faults.FaultPlan or None
    hang_timeout_s: float = 60.0            # cap for injected hangs when
                                            # timeout_s is None

    def cell_env(self, slot) -> dict:
        env = dict(os.environ)
        env.update(self.extra_env)
        if self.gpu_ids:
            env["CUDA_VISIBLE_DEVICES"] = str(slot)
        return env


def process_fault(plan, run_id: str, idx: int) -> Optional[str]:
    """Which process fault (if any) the plan injects into this cell's first
    attempt. Deterministic in (plan.seed, spec.kind, run_id) — a chaotic
    sweep replays the same kills. ``FaultSpec.workers`` for process-site
    specs are CELL indices in submission order (empty = every cell,
    thinned by ``prob``)."""
    if plan is None:
        return None
    import zlib

    from repro_torch.faults.plan import PROCESS_FAULTS
    for spec in plan.faults:
        if spec.kind not in PROCESS_FAULTS:
            continue
        if spec.workers and idx not in spec.workers:
            continue
        if spec.prob >= 1.0:
            return spec.kind
        h = zlib.crc32(f"{plan.seed}:{spec.kind}:{run_id}".encode())
        if (h % (1 << 20)) / float(1 << 20) < spec.prob:
            return spec.kind
    return None


def _attempt_cell(pool: WorkerPool, slot, run_id: str, spec, out_path: str,
                  run_kw: Mapping, fault: Optional[str],
                  attempt: int) -> dict:
    """One subprocess attempt; returns {"ok": bool, ...} with returncode +
    stderr tail on failure, and on success the attempt's wall time and the
    worker's own ``worker_timing`` line."""
    with tempfile.NamedTemporaryFile(
            "w", suffix=".spec.json", delete=False) as f:
        f.write(spec.to_json())
        spec_path = f.name
    cmd = [sys.executable, "-m", "repro_torch.exec.worker",
           "--spec", spec_path, "--out", out_path,
           "--run-kw", json.dumps(dict(run_kw))]
    if fault is not None:
        cmd += ["--fault", fault]
    timeout = pool.timeout_s
    if timeout is not None:
        timeout = timeout * (pool.timeout_escalation ** attempt)
    elif fault == "hang":
        timeout = pool.hang_timeout_s    # never let injected chaos wedge
    env = pool.cell_env(slot)
    env.setdefault("PYTHONPATH", os.pathsep.join(
        p for p in (os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              env=env, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": "timeout", "attempt": attempt,
                "slot": str(slot), "injected_fault": fault,
                "detail": f"attempt exceeded {timeout}s"}
    finally:
        os.unlink(spec_path)
    if proc.returncode != 0 or not os.path.exists(out_path):
        return {"ok": False, "error": "worker-failed", "attempt": attempt,
                "slot": str(slot), "injected_fault": fault,
                "returncode": proc.returncode,
                "stderr_tail": (proc.stderr or proc.stdout or "")[-2000:]}
    return {"ok": True, "attempt": attempt, "injected_fault": fault,
            "wall_s": time.perf_counter() - t0,
            "worker_timing": _worker_timing(proc.stdout)}


def _worker_timing(stdout: str) -> Optional[dict]:
    lines = (stdout or "").strip().splitlines()
    try:
        return json.loads(lines[-1])["worker_timing"] if lines else None
    except (ValueError, KeyError, TypeError):
        return None


def _run_cell_subprocess(pool: WorkerPool, slots: queue.Queue, run_id: str,
                         spec, out_path: str, run_kw: Mapping,
                         fault: Optional[str] = None) -> dict:
    """Run one cell with bounded retry; returns a status dict carrying the
    per-attempt history (ledger failure forensics — satellite of the chaos
    layer). ``fault`` is injected on attempt 0 only."""
    history = []
    max_attempts = 1 + max(int(pool.max_retries), 0)
    for attempt in range(max_attempts):
        slot = slots.get()          # fresh slot per attempt: host re-queue
        try:
            status = _attempt_cell(pool, slot, run_id, spec, out_path,
                                   run_kw, fault if attempt == 0 else None,
                                   attempt)
        finally:
            slots.put(slot)
        if status.get("ok"):
            status["attempts"] = attempt + 1
            status["attempt_history"] = history
            status["injected_fault"] = fault
            return status
        history.append(status)
        if attempt + 1 < max_attempts and pool.backoff_s > 0:
            time.sleep(pool.backoff_s * (2 ** attempt))
    last = history[-1]
    return {"ok": False, "error": last.get("error", "unknown"),
            "detail": last.get("detail") or last.get("stderr_tail", ""),
            "returncode": last.get("returncode"),
            "stderr_tail": last.get("stderr_tail", ""),
            "attempts": max_attempts, "attempt_history": history,
            "injected_fault": fault}


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def _atomic_write_json(path: str, payload: dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)


def _artifact_path(out_dir: str, run_id: str) -> str:
    # hand-made run ids may contain path separators (e.g. "fig1/cm/ALIE")
    return os.path.join(out_dir, run_id.replace(os.sep, "__") + ".json")


def _group_digest(key: str) -> str:
    return hashlib.sha1(key.encode()).hexdigest()[:10]


def run_cells(cells: Sequence[Tuple[str, object]], *,
              out_dir: Optional[str] = None,
              ledger_path: Optional[str] = None,
              resume: bool = False,
              batch="auto",
              pool: Optional[WorkerPool] = None,
              run_kw: Optional[Mapping] = None,
              cell_hook: Optional[Callable] = None,
              sink=None,
              verbose: bool = False) -> SweepRun:
    """Execute ``[(run_id, spec), ...]`` through the execution engine.

    ``batch``: "auto" runs every eligible multi-seed group as one (see
    ``batching.can_batch``); False forces per-cell serial execution.
    ``cell_hook(run_id, spec, exp) -> extra run_kw`` attaches per-cell loop
    knobs that need the built Experiment (benchmark probes / early-stop
    callbacks); hooked cells always run serially in-process.
    ``pool`` sends serial cells to pinned worker subprocesses instead
    (hooked cells and non-JSON loop knobs stay in-process — closures don't
    cross processes; without ``out_dir`` the workers hand results back
    through a scratch dir that is cleaned up afterwards).
    ``run_kw["device"]`` is every cell's device (the card when absent).
    ``sink``: a ``repro_torch.obs.sink.MetricSink``. In-process serial
    cells get a run_id-tagged view of it threaded into the runner
    (round/trace events), every cell and seed group is wrapped in a span
    event, and the final engine accounting lands as ``sweep_*`` gauges.
    Subprocess cells don't stream (sinks don't cross processes) — their
    artifacts carry the history instead.
    """
    run_kw = dict(run_kw or {})
    srun = SweepRun()
    srun.stats["n_cells"] = len(cells)
    ledger = None
    if ledger_path is None and out_dir:
        ledger_path = os.path.join(out_dir, "ledger.jsonl")
    if ledger_path:
        ledger = Ledger(ledger_path)

    # subprocess workers hand results back as artifact files; without an
    # out_dir they land in a scratch dir so a pool still works (pinning,
    # timeout, isolation) when the caller only wants in-memory results
    tmp_art_dir = None
    if pool is not None and out_dir is None:
        tmp_art_dir = tempfile.mkdtemp(prefix="repro-exec-")
    art_dir = out_dir or tmp_art_dir

    def _jsonable(kw) -> bool:
        try:
            json.dumps(kw)
            return True
        except (TypeError, ValueError):
            return False

    done = ledger.completed() if (resume and ledger) else set()

    def _load_completed(run_id):
        if out_dir is None:
            return False
        path = _artifact_path(out_dir, run_id)
        if not os.path.exists(path):
            return False
        try:
            with open(path) as f:
                srun.artifacts[run_id] = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        srun.skipped.add(run_id)
        return True

    prov = {"git_sha": git_sha(),
            "device_kind": device_kind(run_kw.get("device"))}

    def _start(run_id, spec, engine, group):
        if ledger:
            ledger.append(run_id, "started", spec=spec.to_dict(),
                          engine=engine, group=group, **prov)

    def _commit(run_id, result: RunResult, engine, group):
        payload = result.to_dict()
        srun.results[run_id] = result
        srun.artifacts[run_id] = payload
        if out_dir:
            _atomic_write_json(_artifact_path(out_dir, run_id), payload)
        if ledger:
            ledger.append(run_id, "done", engine=engine, group=group,
                          wall_s=result.wall_s, **prov)

    def _fail(run_id, engine, group, err):
        rec = {"engine": engine, "group": group,
               "error": f"{type(err).__name__}: {err}",
               "traceback": traceback.format_exc(limit=20)}
        srun.failures[run_id] = rec
        if ledger:
            ledger.append(run_id, "failed", **{**prov, **rec})

    executor = slots = None
    futures = {}
    sub_idx = [0]          # subprocess submission order (fault selection)
    if pool is not None:
        executor = concurrent.futures.ThreadPoolExecutor(pool.max_workers)
        slots = queue.Queue()
        ids = list(pool.gpu_ids) if pool.gpu_ids else list(
            range(pool.max_workers))
        for s in ids:
            slots.put(s)

    def _run_serial(run_id, spec, group):
        if run_id in done and _load_completed(run_id):
            return
        kw = dict(run_kw)
        exp = None
        if cell_hook is not None:
            exp = build(spec, kw.pop("device", None))
            kw.update(cell_hook(run_id, spec, exp) or {})
        if pool is not None and exp is None and _jsonable(kw):
            _start(run_id, spec, "subprocess", group)
            out_path = _artifact_path(art_dir, run_id)
            fault = process_fault(pool.fault_plan, run_id, sub_idx[0])
            sub_idx[0] += 1
            fut = executor.submit(_run_cell_subprocess, pool, slots, run_id,
                                  spec, out_path, kw, fault)
            futures[fut] = (run_id, out_path, group)
            return
        engine = "serial"
        _start(run_id, spec, engine, group)
        if sink is not None and "sink" not in kw:
            kw["sink"] = TagSink(sink, run_id=run_id)
        try:
            with obs_span(sink, "cell", run_id=run_id, engine=engine):
                if exp is not None:
                    result = exp.run(**kw)
                else:
                    result = run_spec(spec, **kw)
        except Exception as e:                    # noqa: BLE001 — isolate
            _fail(run_id, engine, group, e)
            return
        srun.stats["executed_cells"] += 1
        srun.stats["serial_cells"] += 1
        _commit(run_id, result, engine, group)

    for key, members in batching.group_cells(cells):
        digest = _group_digest(key)
        batchable = (batch is not False    # "auto"/True both allow groups
                     and cell_hook is None
                     and batching.can_batch(members, run_kw))
        if not batchable:
            for run_id, spec in members:
                _run_serial(run_id, spec, digest)
            continue
        # seed groups commit atomically, as in the reference: resume either
        # skips the whole group or re-runs all of it
        if done.issuperset(rid for rid, _ in members):
            if all(_load_completed(rid) for rid, _ in members):
                continue
            for rid, _ in members:       # torn artifacts: recompute
                srun.artifacts.pop(rid, None)
                srun.skipped.discard(rid)
        for run_id, spec in members:
            _start(run_id, spec, "group", digest)
        try:
            with obs_span(sink, "seed_group", group=digest,
                          n_cells=len(members)):
                results, _ = batching.run_group(members, **run_kw)
        except Exception as e:                    # noqa: BLE001 — isolate
            for run_id, _ in members:
                _fail(run_id, "group", digest, e)
            continue
        srun.stats["seed_groups"] += 1
        srun.stats["executed_cells"] += len(members)
        for run_id, _ in members:
            _commit(run_id, results[run_id], "group", digest)

    try:
        for fut in concurrent.futures.as_completed(futures):
            run_id, out_path, group = futures[fut]
            try:
                status = fut.result()
            except Exception as e:                # noqa: BLE001 — isolate
                status = {"ok": False,
                          "error": f"{type(e).__name__}: {e}",
                          "detail": traceback.format_exc(limit=20)}
            if status.get("ok"):
                with open(out_path) as f:
                    srun.artifacts[run_id] = json.load(f)
                srun.stats["executed_cells"] += 1
                srun.stats["subprocess_cells"] += 1
                if status.get("attempts", 1) > 1:
                    srun.stats["retried_cells"] = (
                        srun.stats.get("retried_cells", 0) + 1)
                if ledger:
                    ledger.append(run_id, "done", engine="subprocess",
                                  group=group,
                                  attempts=status.get("attempts", 1),
                                  injected_fault=status.get("injected_fault"),
                                  attempt_history=status.get(
                                      "attempt_history", []),
                                  wall_s=status.get("wall_s"),
                                  worker_timing=status.get("worker_timing"),
                                  **prov)
            else:
                rec = {"engine": "subprocess", "group": group,
                       "error": status.get("error", "unknown"),
                       "detail": status.get("detail", ""),
                       "returncode": status.get("returncode"),
                       "stderr_tail": status.get("stderr_tail", ""),
                       "attempts": status.get("attempts", 1),
                       "attempt_history": status.get("attempt_history", []),
                       "injected_fault": status.get("injected_fault")}
                srun.failures[run_id] = rec
                if ledger:
                    ledger.append(run_id, "failed", **{**prov, **rec})
    finally:
        if executor is not None:
            executor.shutdown()
        if tmp_art_dir is not None:
            shutil.rmtree(tmp_art_dir, ignore_errors=True)
    if verbose and srun.failures:
        for rid, rec in srun.failures.items():
            print(f"[exec] FAILED {rid}: {rec['error']}")
    if sink is not None:
        for k, v in srun.stats.items():
            sink.emit({"type": "gauge", "name": f"sweep_{k}", "value": v})
        sink.emit({"type": "counter", "name": "sweep_failures",
                   "value": len(srun.failures)})
    return srun
