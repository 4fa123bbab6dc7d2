"""Chaos driver: run the fault matrix and emit the fault report (port of
``repro/launch/chaos.py``). Runs on the card unless ``--device cpu``.

One command sweeps {rule} x {backend} x {fault kind} through the chaos
layer (``repro_torch.faults``, DESIGN.md §6): every cell runs a seeded
FaultPlan at ``prob=1`` on a fixed honest-worker set chosen inside the
guard's delta budget (``2·(n_byz + f) < n``), with the fail-closed guard
ON and the telemetry twin tracing, then gates on graceful degradation:

  * the trajectory completes and every logged loss / g_norm is finite;
  * the guard's fault recall is 1.0 for the non-finite kinds (nan_grad,
    inf_blowup); stale_replay is finite by design (the robust rules
    contain it) and corrupt_wire garbles payloads that may stay
    structurally valid, so those two report recall without gating on it;
  * gspmd and pallas final losses agree per (rule, kind): a coarse
    cross-backend parity check.

A guard-OFF control cell (``mean``, nan_grad, no masking) is also run and
is expected to go non-finite: chaos without the guard must visibly fail,
or the matrix tests nothing.

Artifacts in ``--out-dir`` (default experiments/chaos/):

  * ``fault_report.json``: the verdict per cell and the summary;
  * ``chaos_metrics.jsonl``: the metric-event stream (round / trace /
    fault events), verified through ``repro_torch.obs.sink.verify_jsonl``.

Quickstart::

  PYTHONPATH=src python -m repro_torch.launch.chaos --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os

from repro_torch.api import RunSpec

RULES = ("cm", "tm", "krum", "rfa")
BACKENDS = ("gspmd", "pallas")
DENSE_KINDS = ("nan_grad", "inf_blowup", "stale_replay")
WIRE_KINDS = ("corrupt_wire",)        # wire payloads exist under pallas only
GATED_RECALL = ("nan_grad", "inf_blowup")


def _faulty_workers(n_workers: int, n_byz: int, f: int) -> list:
    """The last ``f`` (honest) worker indices: disjoint from the Byzantine
    prefix, so 2·(n_byz + f) < n_workers is the caller's check."""
    return list(range(n_workers - f, n_workers))


def cell_spec(rule: str, backend: str, kind: str, *, n_workers: int,
              n_byz: int, n_faulty: int, steps: int, seed: int,
              guard: bool = True) -> RunSpec:
    plan = {"seed": seed,
            "faults": [{"kind": kind, "prob": 1.0,
                        "workers": _faulty_workers(n_workers, n_byz,
                                                   n_faulty)}]}
    base = dict(task="logreg", n_workers=n_workers, n_byz=n_byz,
                attack="ALIE", aggregator=rule, bucket_size=0,
                agg_mode=backend, lr=0.2, steps=steps, seed=seed,
                faults=plan, fault_guard=guard, trace=guard,
                data_kwargs={"dim": 64, "n_samples": 16 * n_workers,
                             "batch_size": 8})
    if kind in WIRE_KINDS:
        # bit flips act on a wire payload: the MARINA VR rounds pack
        # compressed deltas onto the kernel wire under pallas
        base.update(method="marina", p=0.5, compressor="topk",
                    compressor_kwargs={"ratio": 0.25})
    else:
        base.update(method="sgd")
    return RunSpec(**base)


def run_cell(spec: RunSpec, kind: str, *, log_every: int, sink=None,
             device=None) -> dict:
    res = spec.run(device, log_every=log_every, warmup=True, sink=sink)
    finite = all(math.isfinite(m["loss"]) and math.isfinite(m["g_norm"])
                 for m in res.history)
    recalls = [m["fault_recall"] for m in res.history
               if "fault_recall" in m]
    precisions = [m["fault_precision"] for m in res.history
                  if "fault_precision" in m]
    out = {
        "rule": spec.aggregator, "backend": spec.agg_mode, "kind": kind,
        "final_loss": res.history[-1]["loss"],
        "finite": finite,
        "fault_recall": (sum(recalls) / len(recalls)) if recalls else None,
        "fault_precision": (sum(precisions) / len(precisions))
        if precisions else None,
        "rounds_traced": len(recalls),
    }
    ok = finite
    if kind in GATED_RECALL and recalls:
        ok = ok and min(recalls) == 1.0
    out["ok"] = ok
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="fault-matrix chaos runs (repro_torch.faults)")
    ap.add_argument("--rules", default=",".join(RULES),
                    help=f"comma list of robust rules (default {RULES})")
    ap.add_argument("--backends", default=",".join(BACKENDS),
                    help=f"comma list of agg backends (default {BACKENDS})")
    ap.add_argument("--kinds", default=",".join(DENSE_KINDS + WIRE_KINDS),
                    help="comma list of fault kinds to inject")
    ap.add_argument("--n-workers", type=int, default=12)
    ap.add_argument("--n-byz", type=int, default=2)
    ap.add_argument("--n-faulty", type=int, default=2)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--log-every", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny matrix for CI: cm+rfa x both backends, "
                         "nan_grad + stale_replay + corrupt_wire, 8 steps")
    ap.add_argument("--out-dir", default="experiments/chaos")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the obs.sink verify pass on the emitted "
                         "metrics stream")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         '"cpu" for the plain PyTorch path)')
    return ap


def main(argv=None) -> int:
    """Run the matrix; 0 when the report is GREEN, else 1. A cell that
    raises is reported failed and the grid goes on."""
    args = build_parser().parse_args(argv)
    rules = tuple(args.rules.split(","))
    backends = tuple(args.backends.split(","))
    kinds = tuple(args.kinds.split(","))
    if args.smoke:
        rules = ("cm", "rfa")
        kinds = ("nan_grad", "stale_replay", "corrupt_wire")
        args.steps, args.log_every = 8, 2
    if 2 * (args.n_byz + args.n_faulty) >= args.n_workers:
        raise SystemExit(
            f"2*(n_byz={args.n_byz} + n_faulty={args.n_faulty}) >= "
            f"n_workers={args.n_workers}: outside the guard's delta budget "
            "— the matrix would test nothing (raise --n-workers)")
    from repro_torch.api.runner import resolve_device
    device = resolve_device(args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    from repro_torch.obs.sink import JsonlSink, verify_jsonl
    stream = os.path.join(args.out_dir, "chaos_metrics.jsonl")
    if os.path.exists(stream):
        os.remove(stream)
    sink = JsonlSink(stream)

    cfg_kw = dict(n_workers=args.n_workers, n_byz=args.n_byz,
                  n_faulty=args.n_faulty, steps=args.steps, seed=args.seed)
    cells = []
    for kind in kinds:
        site = "wire" if kind in WIRE_KINDS else "tensor"
        for rule in rules:
            for backend in backends:
                if kind in WIRE_KINDS and backend != "pallas":
                    continue            # no wire payloads off pallas
                spec = cell_spec(rule, backend, kind, **cfg_kw)
                try:
                    cell = run_cell(spec, kind, log_every=args.log_every,
                                    sink=sink, device=device)
                except Exception as e:  # noqa: BLE001 — report, keep grid
                    cell = {"rule": rule, "backend": backend, "kind": kind,
                            "ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                sink.emit({"type": "fault", "kind": kind, "site": site,
                           "rule": rule, "backend": backend,
                           "injected_workers": _faulty_workers(
                               args.n_workers, args.n_byz, args.n_faulty),
                           "ok": bool(cell["ok"])})
                cells.append(cell)
                status = "ok" if cell["ok"] else "FAIL"
                print(f"[chaos] {kind:12s} {rule:5s} {backend:6s} {status}"
                      + (f"  recall={cell['fault_recall']:.2f}"
                         if cell.get("fault_recall") is not None else "")
                      + (f"  {cell.get('error', '')}"), flush=True)

    # cross-backend parity per (rule, kind): a coarse gate
    parity = []
    for kind in kinds:
        for rule in rules:
            pair = [c for c in cells
                    if c.get("kind") == kind and c.get("rule") == rule
                    and "final_loss" in c]
            if len(pair) == 2:
                a, b = pair[0]["final_loss"], pair[1]["final_loss"]
                close = math.isfinite(a) and math.isfinite(b) and \
                    abs(a - b) <= 1e-2 * max(abs(a), abs(b), 1e-6)
                parity.append({"rule": rule, "kind": kind,
                               "loss": [a, b], "close": close})

    # the no-guard control: chaos without the guard must visibly fail.
    # ``mean`` lets a NaN through an unguarded average, where the robust
    # rules degrade gracefully (a median never selects a NaN row)
    ctrl_spec = cell_spec("mean", "gspmd", "nan_grad", guard=False, **cfg_kw)
    ctrl = ctrl_spec.run(device, log_every=args.steps, warmup=True)
    ctrl_nonfinite = not math.isfinite(ctrl.history[-1]["loss"])
    print(f"[chaos] control (guard OFF, nan_grad): "
          f"{'non-finite as expected' if ctrl_nonfinite else 'FINITE (?)'}")

    green = all(c["ok"] for c in cells) and \
        all(p["close"] for p in parity) and ctrl_nonfinite
    report = {
        "green": green,
        "device": str(device),
        "grid": {"rules": list(rules), "backends": list(backends),
                 "kinds": list(kinds)},
        "budget": {"n_workers": args.n_workers, "n_byz": args.n_byz,
                   "n_faulty": args.n_faulty},
        "cells": cells,
        "cross_backend_parity": parity,
        "control_guard_off_nonfinite": ctrl_nonfinite,
    }
    path = os.path.join(args.out_dir, "fault_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    sink.close()
    print(f"[chaos] report -> {path} ({'GREEN' if green else 'RED'})")

    if not args.no_verify:
        counts = verify_jsonl(stream)
        print(f"[chaos] {stream}: verified — "
              + ", ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    return 0 if green else 1


if __name__ == "__main__":
    raise SystemExit(main())
