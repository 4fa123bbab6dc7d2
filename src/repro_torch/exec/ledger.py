"""Crash-safe append-only run ledger (port of ``repro/exec/ledger.py``).

One JSONL file per sweep records every cell's lifecycle as append-only
events keyed by the sweep's stable run ids:

    {"run_id": ..., "status": "started", "spec": {...}, "ts": ...}
    {"run_id": ..., "status": "done", "git_sha": ..., "device_kind": ...,
     "engine": "group", "group": ..., "wall_s": ..., "ts": ...}

Each record is written with flush+fsync, so a killed sweep leaves at worst
one truncated trailing line — ``iter_records`` tolerates (and skips) it,
and the next append starts on a fresh line. The LAST record per run id
wins: ``completed()`` is the resume set (``scheduler.run_cells`` skips
those cells and re-runs ``started`` / ``failed`` ones), and the full
event stream is the provenance trail (resolved spec, git sha, device
kind, wall time per cell).
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import time
from typing import Iterator, Optional


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """HEAD of the repo this package lives in ("unknown" outside git)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)))
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_kind(device=None) -> str:
    """The device type the cells run on and the count visible, e.g.
    "cuda:1" or "cpu:1"; ``None`` means the card, as in ``api.run``."""
    import torch
    kind = torch.device("cuda" if device is None else device).type
    count = torch.cuda.device_count() if kind == "cuda" else 1
    return f"{kind}:{count}"


class Ledger:
    """Append-only JSONL event log for one sweep."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    # -- writing ------------------------------------------------------------
    def append(self, run_id: str, status: str, **fields) -> dict:
        rec = {"run_id": run_id, "status": status, "ts": time.time(),
               **fields}
        line = json.dumps(rec, sort_keys=True)
        with open(self.path, "ab") as f:
            # heal a torn tail from a killed writer: never glue a new
            # record onto a half-written line
            if f.tell() > 0:
                with open(self.path, "rb") as r:
                    r.seek(-1, os.SEEK_END)
                    torn = r.read(1) != b"\n"
            else:
                torn = False
            f.write(b"\n" * torn + line.encode() + b"\n")
            f.flush()
            os.fsync(f.fileno())
        return rec

    # -- reading ------------------------------------------------------------
    def iter_records(self) -> Iterator[dict]:
        """Yield records in append order, skipping a torn trailing line."""
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue            # torn write from a killed process
                if isinstance(rec, dict) and "run_id" in rec:
                    yield rec

    def load(self) -> dict:
        """{run_id: last record} — later events supersede earlier ones."""
        state = {}
        for rec in self.iter_records():
            state[rec["run_id"]] = rec
        return state

    def by_status(self, status: str) -> set:
        return {rid for rid, rec in self.load().items()
                if rec.get("status") == status}

    def completed(self) -> set:
        return self.by_status("done")

    def failed(self) -> set:
        return self.by_status("failed")

    def record(self, run_id: str) -> Optional[dict]:
        return self.load().get(run_id)
