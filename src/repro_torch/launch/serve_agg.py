"""Streaming-aggregation service CLI (port of
``repro/launch/serve_agg.py``).

Drives the buffered-asynchronous Byzantine-robust aggregation service
(``repro_torch.serve``) from the command line: a seeded arrival process
(with optional straggler / dropout / duplicate / crash / hang chaos)
feeds client updates into the double buffer, and every K deduplicated
updates fire the robust aggregator with FedBuff staleness weighting. The
flags are generated from ``ServeSpec``'s fields, with choices from the
component registry. Runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve_agg \\
      --n-clients 32 --n-byz 4 --buffer-size 8 --rounds 50 \\
      --attack ALIE --aggregator cm --agg-mode pallas --arrival exp \\
      --chaos straggler_frac=0.2,dropout=0.05,duplicate=0.1

  # replay a saved trace, journal every round, keep restart points
  PYTHONPATH=src python -m repro_torch.launch.serve_agg --arrival trace \\
      --chaos path=trace.json --ledger runs/serve.jsonl \\
      --checkpoint runs/serve_ck --checkpoint-every 10

``--spec`` / ``--spec-out`` load / dump a serialized ServeSpec (either
package's); ``--resume`` restarts from a checkpoint prefix and replays
the arrival stream from its saved cursor, which ends bit for bit as the
uninterrupted run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.api import ServeSpec, components
from repro_torch.api.spec import (ARRIVAL_MODES, SERVE_AGG_MODES,
                                  STALENESS_MODES)

_CHOICE_KINDS = {"arch": "arch", "method": "method", "attack": "attack",
                 "aggregator": "aggregator", "compressor": "compressor"}
_STATIC_CHOICES = {"agg_mode": SERVE_AGG_MODES, "arrival": ARRIVAL_MODES,
                   "staleness": STALENESS_MODES, "task": ("logreg", "lm")}


def _parse_kv(text: str) -> dict:
    """"a=1,b=0.5,c=foo" -> {"a": 1, "b": 0.5, "c": "foo"} (JSON
    scalars)."""
    out: dict = {}
    for item in filter(None, (s.strip() for s in text.split(","))):
        k, _, v = item.partition("=")
        if not _:
            raise argparse.ArgumentTypeError(
                f"expected key=value, got {item!r}")
        try:
            out[k.strip()] = json.loads(v)
        except json.JSONDecodeError:
            out[k.strip()] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="buffered-async robust aggregation via "
                    "repro_torch.api.ServeSpec")
    for f in dataclasses.fields(ServeSpec):
        flag = "--" + f.name.replace("_", "-")
        if f.name in _CHOICE_KINDS:
            ap.add_argument(flag, default=f.default,
                            choices=(components(_CHOICE_KINDS[f.name])
                                     if f.name != "arch"
                                     else (None,) + components("arch")))
        elif f.name in _STATIC_CHOICES:
            ap.add_argument(flag, default=f.default,
                            choices=_STATIC_CHOICES[f.name])
        elif f.name.endswith("_kwargs"):
            alias = ("--chaos",) if f.name == "arrival_kwargs" else ()
            ap.add_argument(flag, *alias, type=_parse_kv,
                            default={}, metavar="K=V,...",
                            help=f"{f.name} as comma-separated key=value")
        elif isinstance(f.default, bool):
            ap.add_argument(flag, action="store_true")
        else:
            ap.add_argument(flag, type=type(f.default), default=f.default)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--spec", help="load a serialized ServeSpec JSON")
    ap.add_argument("--spec-out", help="dump the resolved spec JSON")
    ap.add_argument("--ledger", help="journal fired rounds to this JSONL")
    ap.add_argument("--checkpoint", help="checkpoint path prefix")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    metavar="R", help="checkpoint cadence in fired rounds")
    ap.add_argument("--resume", help="checkpoint prefix to restart from")
    ap.add_argument("--digest", action="store_true",
                    help="sha1 the params into each ledger record "
                         "(a device read every round)")
    ap.add_argument("--sync-each-fire", action="store_true",
                    help="synchronize after every fire and report latency "
                         "percentiles instead of overlapping ingest with "
                         "aggregation")
    ap.add_argument("--metrics-out", help="dump ServeResult JSON here")
    ap.add_argument("--latency-sample-every", type=int, default=8,
                    metavar="N", help="free-running mode: fence every Nth "
                    "fire for sampled latency percentiles (0 = never)")
    from repro_torch.obs import profile
    profile.add_cli_args(ap)            # --metrics-out-jsonl, --profile-dir
    ap.add_argument("--quiet", action="store_true")
    return ap


def spec_from_args(args) -> ServeSpec:
    if args.spec:
        with open(args.spec) as f:
            return ServeSpec.from_json(f.read())
    fields = {f.name: getattr(args, f.name)
              for f in dataclasses.fields(ServeSpec)}
    return ServeSpec(**fields)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from repro_torch.obs import profile
    if args.profile_dir:
        profile.enable_step_markers()
    spec = spec_from_args(args)
    if args.spec_out:
        with open(args.spec_out, "w") as f:
            f.write(spec.to_json())
    with profile.profile_trace(args.profile_dir):
        res = spec.build(args.device).run(
            ledger_path=args.ledger, checkpoint=args.checkpoint,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            sync_each_fire=args.sync_each_fire, digest=args.digest,
            metrics_jsonl=args.metrics_out_jsonl,
            latency_sample_every=args.latency_sample_every,
            verbose=not args.quiet)
    pct = res.latency_percentiles()
    lat = (f" p50 {pct['p50_ms']:.2f}ms p99 {pct['p99_ms']:.2f}ms"
           if pct else "")
    print(f"[serve_agg] {res.stats['rounds']} rounds, "
          f"{res.stats['accepted']} updates "
          f"({res.stats['rej_replay']} replays + "
          f"{res.stats['rej_dup_client']} dups rejected, "
          f"{res.stats['dropped']} dropped) in {res.wall_s:.2f}s — "
          f"{res.updates_per_s:.1f} updates/s{lat}")
    spct = res.staleness_percentiles()
    if spct:
        print(f"[serve_agg] staleness p50 {spct['staleness_p50']:.0f} "
              f"p90 {spct['staleness_p90']:.0f} "
              f"worst {spct['staleness_worst']:.0f}")
    if res.history:
        m = res.history[-1]
        print(f"[serve_agg] final loss {m['loss']:.4f} "
              f"|g| {m['g_norm']:.3e} "
              f"staleness mean {m['staleness_mean']:.2f}")
    if spec.trace and res.traces:
        det = res.detection_summary()
        print(f"[serve_agg] detection over {det['rounds']} traced rounds: "
              f"precision {det['precision']:.3f} "
              f"recall {det['recall']:.3f} "
              f"byz_leakage {det['byz_leakage']:.3f}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(res.to_dict(), f, indent=1)


if __name__ == "__main__":
    main()
