"""Per-cell artifact aggregation into paper-figure tables (port of
``repro/exec/aggregate.py``, a copy: the port imports nothing of the
reference).

``summarize`` folds the per-cell metric payloads (``RunResult.to_dict()``
JSONs — in memory from a ``SweepRun`` or loaded back from an artifact
directory) into one summary table: cells are grouped by their spec minus
the seed (the key ``exec.batching`` groups by), each group reports
mean±std over its seeds for every final-step metric, and the best group
per headline metric is selected. Timing fields (``wall_s``) are excluded
so the summary is a pure function of the trajectories: that is what
makes a killed-and-resumed sweep's summary equal an uninterrupted one's
byte for byte.

``write_summary`` serializes with sorted keys so equal summaries are
equal bytes.
"""
from __future__ import annotations

import json
import math
import os
from typing import Mapping, Optional

SUMMARY_SCHEMA_VERSION = 1

# per-entry fields that are timing noise, not trajectory
_NONDETERMINISTIC = ("wall_s",)


def _group_spec(payload: dict) -> dict:
    spec = dict(payload.get("spec", {}))
    spec.pop("seed", None)
    return spec


def _fmt_value(v) -> str:
    import re
    if isinstance(v, dict):
        v = ",".join(f"{k}:{v[k]}" for k in sorted(v))
    s = str(v)
    return re.sub(r"[^A-Za-z0-9_.:,+-]+", "-", s) or "none"


def _labels(group_specs: list) -> list:
    """Human labels from the fields that actually vary across groups."""
    if len(group_specs) == 1:
        return ["all"]
    keys = sorted({k for g in group_specs for k in g})
    varying = [k for k in keys
               if len({json.dumps(g.get(k), sort_keys=True)
                       for g in group_specs}) > 1]
    labels = ["__".join(f"{k}={_fmt_value(g.get(k))}" for k in varying)
              or "all" for g in group_specs]
    if len(set(labels)) != len(labels):       # fall back to full signature
        labels = [json.dumps(g, sort_keys=True) for g in group_specs]
    return labels


def _mean_std(values: list) -> dict:
    n = len(values)
    mean = sum(values) / n
    var = sum((v - mean) ** 2 for v in values) / n
    return {"mean": mean, "std": math.sqrt(var),
            "min": min(values), "max": max(values), "n": n}


def summarize(artifacts: Mapping[str, dict], *,
              select_metric: str = "loss") -> dict:
    """{run_id: payload} -> summary dict (see module docstring).

    Groups are sorted by their canonical spec signature and seeds sorted
    within a group, so the summary is independent of execution order.
    """
    groups: dict = {}
    for run_id in sorted(artifacts):
        payload = artifacts[run_id]
        key = json.dumps(_group_spec(payload), sort_keys=True)
        groups.setdefault(key, []).append((run_id, payload))

    keys = sorted(groups)
    labels = _labels([json.loads(k) for k in keys])
    out_groups = []
    for key, label in zip(keys, labels):
        members = groups[key]
        finals, seeds, run_ids = [], [], []
        for run_id, payload in members:
            hist = payload.get("history", [])
            finals.append(hist[-1] if hist else {})
            seeds.append(payload.get("spec", {}).get("seed"))
            run_ids.append(run_id)
        metric_names = sorted({m for f in finals for m in f
                               if m not in _NONDETERMINISTIC
                               and isinstance(f[m], (int, float))})
        final = {m: _mean_std([f[m] for f in finals if m in f])
                 for m in metric_names}
        out_groups.append({
            "label": label,
            "spec": json.loads(key),
            "seeds": sorted(seeds, key=lambda s: (s is None, s)),
            "n_seeds": len(members),
            "run_ids": sorted(run_ids),
            "final": final,
        })

    best = None
    scored = [(g["final"][select_metric]["mean"], g["label"])
              for g in out_groups if select_metric in g["final"]]
    if scored:
        mean, label = min(scored)
        best = {"metric": select_metric, "label": label, "mean": mean}
    return {"schema_version": SUMMARY_SCHEMA_VERSION,
            "n_cells": len(artifacts), "n_groups": len(out_groups),
            "groups": out_groups, "best": best}


def load_artifacts(out_dir: str) -> dict:
    """Load every per-cell artifact JSON under ``out_dir`` (skips the
    ledger, summaries, and anything that isn't a RunResult payload)."""
    artifacts = {}
    for name in sorted(os.listdir(out_dir)):
        if (not name.endswith(".json") or name.endswith("_summary.json")
                or name.endswith(".spec.json")):
            continue
        path = os.path.join(out_dir, name)
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(payload, dict) and "spec" in payload:
            artifacts[name[:-len(".json")]] = payload
    return artifacts


def summarize_dir(out_dir: str, **kw) -> dict:
    return summarize(load_artifacts(out_dir), **kw)


def write_summary(path: Optional[str], summary: dict) -> Optional[str]:
    """Deterministic bytes: sorted keys, fixed indent — equal summaries
    are equal files."""
    if not path:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path
