"""repro_torch.exec — resumable sweep execution (port of ``repro.exec``).

* ``batching``  — group cells by signature (spec minus seed) and run each
                  group over one experiment, seed by seed.
* ``scheduler`` — ``run_cells``: the orchestrator (seed groups in
                  process, un-batchable cells optionally sharded over a
                  pinned subprocess ``WorkerPool``, failure isolation).
* ``ledger``    — crash-safe append-only JSONL journal giving
                  ``resume=True`` (skip done, re-run failed) + provenance.
* ``aggregate`` — fold per-cell artifacts into mean±std-over-seeds
                  summary tables.
* ``worker``    — the ``python -m repro_torch.exec.worker`` subprocess
                  entry.

CLI: ``python -m repro_torch.launch.sweep``. ``api.sweep.run_sweep``
routes every sweep through this engine. The names below are imported on
first use, so a worker's injected crash or hang acts before
``import torch``.
"""
import importlib

_EXPORTS = {
    "load_artifacts": "aggregate", "summarize": "aggregate",
    "summarize_dir": "aggregate", "write_summary": "aggregate",
    "can_batch": "batching", "group_cells": "batching",
    "group_key": "batching", "run_group": "batching",
    "Ledger": "ledger", "device_kind": "ledger", "git_sha": "ledger",
    "CompletedCell": "scheduler", "SweepRun": "scheduler",
    "WorkerPool": "scheduler", "run_cells": "scheduler",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
