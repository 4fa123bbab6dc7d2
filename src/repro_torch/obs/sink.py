"""MetricSink: the structured metric-event protocol (a copy of
``repro/obs/sink.py``: JSON only).

Every layer that produces telemetry (``api/runner`` in this package)
emits plain-dict EVENTS into a sink instead of growing its own logging
format. An event always carries a ``"type"``:

  {"type": "round",   ...}   — one logged training/fired round (metrics)
  {"type": "trace",   ...}   — a host-materialized RoundTrace (obs.trace)
  {"type": "counter", "name": ..., "value": ...}  — monotonic counts
  {"type": "gauge",   "name": ..., "value": ...}  — point-in-time values
  {"type": "span",    "name": ..., "wall_s": ...} — timed sections

Sinks are deliberately tiny: ``emit(event)`` + ``close()``. ``JsonlSink``
appends one JSON line per event (the artifact stream CI uploads),
``RingSink`` keeps the last N events in memory (tests, live probes),
``FanoutSink`` multiplexes, ``TagSink`` stamps extra key/values (e.g. the
sweep run_id) onto every event before forwarding.

Span-fencing rule: emitters must NOT force a device sync per event; wall
timing fences only at log-cadence boundaries (the runner's float()
materialization is that fence), so telemetry stays off the asynchronous
launch path.

    python -m repro_torch.obs.sink --verify PATH

checks a stream: it exits non-zero on an empty or non-finite one.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class MetricSink(Protocol):
    def emit(self, event: dict) -> None: ...
    def close(self) -> None: ...


class NullSink:
    """Swallows everything; the no-telemetry default."""

    def emit(self, event: dict) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink:
    """One JSON line per event, appended to ``path``. Line-buffered so a
    crashed run still leaves a readable stream."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)

    def emit(self, event: dict) -> None:
        self._f.write(json.dumps(event) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class RingSink:
    """Keeps the last ``capacity`` events in memory (``.events``)."""

    def __init__(self, capacity: int = 4096):
        self.events: collections.deque = collections.deque(maxlen=capacity)

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass

    def by_type(self, etype: str) -> list:
        return [e for e in self.events if e.get("type") == etype]

    def by_name(self, name: str) -> list:
        return [e for e in self.events if e.get("name") == name]


class FanoutSink:
    """Multiplexes events to several sinks; close() closes them all."""

    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def emit(self, event: dict) -> None:
        for s in self.sinks:
            s.emit(event)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


class TagSink:
    """Stamps ``tags`` onto every event before forwarding (the sweep
    scheduler tags each cell's events with its run_id). Does NOT close the
    underlying sink — it is shared across cells."""

    def __init__(self, base, **tags):
        self.base = base
        self.tags = tags

    def emit(self, event: dict) -> None:
        self.base.emit({**self.tags, **event})

    def close(self) -> None:
        pass


@contextlib.contextmanager
def span(sink, name: str, **fields):
    """Wall-clock a section and emit one span event on exit. The caller is
    responsible for fencing (``torch.cuda.synchronize``) if device work
    must be included, and should only do so at log-cadence boundaries."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sink is not None:
            sink.emit({"type": "span", "name": name,
                       "wall_s": round(time.perf_counter() - t0, 6),
                       **fields})


# ---------------------------------------------------------------------------
# stream verification (the CI gate for traced-smoke artifacts)
# ---------------------------------------------------------------------------

def verify_jsonl(path: str) -> dict:
    """Fail-closed check of a metrics JSONL stream: the file must exist,
    parse line-by-line, contain at least one event, and no numeric field
    of any trace/round/fault event may be NaN/Inf. Returns counts per type.

    ``{"type": "fault", ...}`` events (the chaos layer's injection /
    degradation records) are additionally schema-checked:
    each must carry a ``kind`` from the ``repro_torch.faults`` registry and a
    ``site`` from the known injection sites — a schema-less fault event
    means some emitter is improvising, which would silently corrupt the
    fault-matrix report downstream.

    One deliberate carve-out: a trace event that declares a chaos context
    (``fault_mask`` or ``guard_valid`` present) may carry non-finite
    values in its rule-intermediate diagnostics — a rejected bucket's
    krum score IS ``+inf`` (the guard's sort-fill), and recording that is
    honest telemetry, not a blow-up. Training metrics (round events) and
    every other field stay strictly finite, so a diverged trajectory
    still fails the gate.
    """
    counts: dict = {}
    bad: list = []
    bad_schema: list = []
    # rule intermediates where the fail-closed guard legitimately leaves
    # non-finite markers for rejected rows/buckets (chaos traces only)
    chaos_diag = ("influence", "dist_to_agg", "bucket_weights",
                  "krum_scores", "rfa_weights", "rfa_residual")

    def scan(prefix, v, exempt=()):
        if isinstance(v, dict):
            for k, x in v.items():
                scan(f"{prefix}.{k}", x, () if k not in exempt else ("*",))
        elif isinstance(v, list):
            for i, x in enumerate(v):
                scan(f"{prefix}[{i}]", x, exempt)
        elif (isinstance(v, float) and not math.isfinite(v)
              and "*" not in exempt):
            bad.append(prefix)

    from repro_torch.faults.plan import FAULTS
    fault_sites = ("tensor", "wire", "process")

    with open(path) as f:
        for ln, line in enumerate(f, 1):
            if not line.strip():
                continue
            ev = json.loads(line)
            counts[ev.get("type", "?")] = counts.get(ev.get("type", "?"),
                                                     0) + 1
            if ev.get("type") in ("trace", "round", "fault"):
                chaos = (ev.get("type") == "trace"
                         and ("fault_mask" in ev or "guard_valid" in ev))
                scan(f"line {ln}", ev, chaos_diag if chaos else ())
            if ev.get("type") == "fault":
                if ev.get("kind") not in FAULTS:
                    bad_schema.append(
                        f"line {ln}: kind={ev.get('kind')!r}")
                elif ev.get("site") not in fault_sites:
                    bad_schema.append(
                        f"line {ln}: site={ev.get('site')!r}")
    if not counts:
        raise ValueError(f"{path}: empty metrics stream")
    if bad:
        raise ValueError(
            f"{path}: non-finite values in {len(bad)} field(s), first: "
            + ", ".join(bad[:5]))
    if bad_schema:
        raise ValueError(
            f"{path}: {len(bad_schema)} malformed fault event(s) "
            f"(need kind in {FAULTS} and site in {fault_sites}), first: "
            + "; ".join(bad_schema[:5]))
    return counts


def _main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="verify a metrics JSONL stream (non-empty, finite)")
    ap.add_argument("--verify", required=True, metavar="PATH")
    args = ap.parse_args(argv)
    counts = verify_jsonl(args.verify)
    total = sum(counts.values())
    print(f"[obs.sink] {args.verify}: {total} events ok — "
          + ", ".join(f"{k}={v}" for k, v in sorted(counts.items())))


if __name__ == "__main__":
    _main()
