"""Sweep CLI: run a paper grid through the execution engine (port of
``repro/launch/sweep.py``).

One command owns the whole grid — seed groups over one experiment, the
crash-safe ledger with ``--resume``, an optional pinned worker pool for
the other cells, and the mean±std-over-seeds summary table:

  PYTHONPATH=src python -m repro_torch.launch.sweep \\
      --grid '{"aggregator": ["mean", "cm", "rfa"],
               "attack": ["NA", "BF", "ALIE"]}' \\
      --seeds 0:5 --set steps=300 --out-dir experiments/sweeps/fig1 \\
      --name fig1 --resume

Grid keys are ``RunSpec`` fields (dotted keys reach kwargs dicts, e.g.
``compressor_kwargs.ratio``); ``--base spec.json`` starts from a
serialized spec instead of defaults; ``--set field=value`` tweaks single
fields. Cells run on the card unless ``--device cpu``; ``--workers N
--gpus 0,1`` runs them in N worker processes pinned round-robin to those
cards. Artifacts land in ``--out-dir`` (one ``<run_id>.json`` per cell +
``ledger.jsonl``); the summary goes to ``<out-dir>/<name>_summary.json``
and ``$BENCH_ART_DIR`` (default ``experiments/bench/``).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.api import RunSpec, Sweep
from repro_torch.api.spec import resolve_agg_mode


def _parse_value(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text                      # bare strings: --set attack=ALIE


def _parse_seeds(text: str):
    if ":" in text:
        lo, hi = text.split(":", 1)
        return tuple(range(int(lo or 0), int(hi)))
    return tuple(int(s) for s in text.split(",") if s.strip())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="resumable RunSpec grid execution (repro_torch.exec)")
    ap.add_argument("--base", default=None,
                    help="serialized RunSpec JSON to start from")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    dest="overrides",
                    help="override a base spec field (repeatable; dotted "
                         "keys reach kwargs dicts)")
    ap.add_argument("--grid", type=json.loads, default={},
                    help="JSON dict: RunSpec field -> list of values")
    ap.add_argument("--seeds", type=_parse_seeds, default=None,
                    help='seed axis, "0:5" or "0,1,4" — appended to the '
                         "grid; same-signature seeds run as one group")
    ap.add_argument("--out-dir", default=None,
                    help="artifact dir (per-cell JSON + ledger.jsonl)")
    ap.add_argument("--name", default="sweep",
                    help="summary name: <name>_summary.json")
    ap.add_argument("--resume", action="store_true",
                    help="skip ledger-completed cells, re-run failed ones")
    ap.add_argument("--no-batch", action="store_true",
                    help="force per-cell serial execution (no seed groups)")
    ap.add_argument("--workers", type=int, default=0,
                    help="run un-batchable cells in N pinned worker "
                         "subprocesses (0 = in-process)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-cell timeout in seconds (worker pool only)")
    ap.add_argument("--gpus", default=None,
                    help='comma-separated CUDA_VISIBLE_DEVICES ids round-'
                         'robined over workers, e.g. "0,1,2,3"')
    ap.add_argument("--device", default=None,
                    help='every cell\'s device, e.g. "cpu" (default: the '
                         'card), in process and in the workers')
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--warmup", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="set spec.trace on every cell: log-cadence steps "
                         "run the telemetry twin (aggregator-decision "
                         "RoundTraces + detection metrics; trajectory is "
                         "bit-identical). Traced cells run serially — "
                         "traces are per-trajectory host artifacts")
    from repro_torch.obs import profile
    profile.add_cli_args(ap)            # --metrics-out-jsonl, --profile-dir
    ap.add_argument("--list", action="store_true",
                    help="print the expanded run ids and exit")
    return ap


def sweep_from_args(args) -> Sweep:
    if args.base:
        with open(args.base) as f:
            base = RunSpec.from_json(f.read())
    else:
        base = RunSpec()
    overrides = {}
    for item in args.overrides:
        key, _, val = item.partition("=")
        overrides[key] = _parse_value(val)
    if "agg_mode" in overrides:
        overrides["agg_mode"] = resolve_agg_mode(overrides["agg_mode"])
    if getattr(args, "trace", False):
        overrides["trace"] = True
    if overrides:
        base = base.replace(**overrides)
    grid = dict(args.grid)
    if args.seeds:
        grid["seed"] = args.seeds
    return Sweep(base=base, grid=grid)


def main(argv=None):
    args = build_parser().parse_args(argv)
    sweep = sweep_from_args(args)
    cells = list(sweep.expand())
    if args.list:
        for run_id, _ in cells:
            print(run_id)
        return None

    from repro_torch import exec as xc
    from repro_torch.obs import profile
    from repro_torch.obs.sink import JsonlSink
    pool = None
    if args.workers:
        pool = xc.WorkerPool(
            max_workers=args.workers, timeout_s=args.timeout,
            gpu_ids=args.gpus.split(",") if args.gpus else None)
    run_kw = {"log_every": args.log_every, "warmup": args.warmup}
    if args.device:
        run_kw["device"] = args.device
    sink = (JsonlSink(args.metrics_out_jsonl) if args.metrics_out_jsonl
            else None)
    if args.profile_dir:
        profile.enable_step_markers()   # one 'round' range a round
    try:
        with profile.profile_trace(args.profile_dir):
            srun = xc.run_cells(
                cells, out_dir=args.out_dir, resume=args.resume,
                batch=False if args.no_batch else "auto", pool=pool,
                run_kw=run_kw, sink=sink, verbose=True)
    finally:
        profile.enable_step_markers(False)
        if sink is not None:
            sink.close()

    summary = xc.summarize(srun.artifacts)
    bench_dir = os.environ.get("BENCH_ART_DIR", "experiments/bench")
    for path in filter(None, [
            os.path.join(args.out_dir, f"{args.name}_summary.json")
            if args.out_dir else None,
            os.path.join(bench_dir, f"{args.name}_summary.json")]):
        xc.write_summary(path, summary)
        print(f"[sweep] summary -> {path}")

    st = srun.stats
    print(f"[sweep] {st['n_cells']} cells: {st['executed_cells']} run "
          f"({st['seed_groups']} seed groups, "
          f"{st['serial_cells']} serial, "
          f"{st['subprocess_cells']} subprocess), "
          f"{len(srun.skipped)} resumed, {len(srun.failures)} failed")
    for group in summary["groups"]:
        loss = group["final"].get("loss")
        if loss:
            print(f"  {group['label']:<48} loss "
                  f"{loss['mean']:.4g} ± {loss['std']:.2g} "
                  f"(n={group['n_seeds']})")
    return summary


if __name__ == "__main__":
    main()
