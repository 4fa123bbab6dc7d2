"""Training driver: Byzantine-robust LM training through the declarative
experiment API, any registered method, attack and aggregation backend
(port of ``repro/launch/train.py``).

The CLI is generated from ``RunSpec``'s fields, with choices enumerated
from the component registry (``repro_torch.api.registry``). Legacy flags
(``--agg``, ``--bucket``, ``--opt``, ``--compress-ratio``) work as
aliases. Runs on the card unless ``--device cpu``. Example:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --steps 100 --n-workers 8 --n-byz 2 --attack ALIE \\
      --agg cm --method marina --agg-mode auto

--agg-mode "auto" resolves to the kernel path ("pallas") where a CUDA
device is present and the plain path ("gspmd") elsewhere.

``--spec path.json`` loads a serialized RunSpec instead of flags;
``--spec-out path.json`` dumps the resolved spec next to the metrics, so
every run is reproducible from its artifacts alone.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.api import (RunSpec, build, components, describe,
                             resolve_agg_mode)

# spec fields whose CLI choices enumerate from the unified registry
_CHOICE_KINDS = {"arch": "arch", "method": "method", "attack": "attack",
                 "aggregator": "aggregator", "compressor": "compressor",
                 "optimizer": "optimizer"}
# pre-redesign flag spellings, kept as aliases of the spec-named flags
_LEGACY_ALIASES = {"aggregator": ("--agg",), "bucket_size": ("--bucket",),
                   "optimizer": ("--opt",)}
# train-appropriate defaults where they differ from RunSpec's (logreg-tuned)
_TRAIN_DEFAULTS = {"arch": "qwen3-1.7b", "n_workers": 8, "n_byz": 0,
                   "attack": "NA", "lr": 3e-3,
                   # None = derive from --compress-ratio (legacy behaviour)
                   "compressor": None}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Byzantine-robust training via repro_torch.api.RunSpec")
    for f in dataclasses.fields(RunSpec):
        if f.name == "task":        # this driver is the LM task
            continue
        flag = "--" + f.name.replace("_", "-")
        flags = (flag,) + _LEGACY_ALIASES.get(f.name, ())
        default = _TRAIN_DEFAULTS.get(f.name, f.default)
        if f.name == "agg_mode":
            ap.add_argument(flag, default="auto",
                            choices=("auto",) + components("agg_mode"),
                            help="server-side aggregation backend "
                                 "(auto = pallas on a CUDA device, gspmd "
                                 "elsewhere)")
        elif f.name in _CHOICE_KINDS:
            kind = _CHOICE_KINDS[f.name]
            ap.add_argument(*flags, default=default,
                            choices=components(kind),
                            help=f"registry {kind!r}: "
                                 + ", ".join(components(kind)))
        elif f.default_factory is dict:          # per-component kwargs
            ap.add_argument(flag, type=json.loads, default={},
                            help=f"JSON dict merged into spec.{f.name}")
        elif isinstance(default, bool):          # bool('False') is True
            ap.add_argument(*flags, action="store_true", default=default)
        else:
            ap.add_argument(flags[0], *flags[1:], type=type(f.default),
                            default=default)
    # stream/model knobs (forwarded into spec.data_kwargs)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--per-worker-batch", type=int, default=4)
    ap.add_argument("--heterogeneous", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--compress-ratio", type=float, default=1.0,
                    help="legacy: <1.0 selects randk at this ratio when "
                         "--compressor is not given")
    # loop knobs (live in the shared runner, not the spec)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None,
                    help="path prefix: save the full engine state (final + "
                         "every --checkpoint-every steps)")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="periodic checkpoint cadence in steps")
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="restart from a checkpoint prefix the runner "
                         "wrote; the trajectory continues exactly where "
                         "the interrupted run left off")
    ap.add_argument("--metrics-out", default=None)
    from repro_torch.obs import profile
    profile.add_cli_args(ap)            # --metrics-out-jsonl, --profile-dir
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         '"cpu" for the plain PyTorch path)')
    ap.add_argument("--spec", default=None,
                    help="load a serialized RunSpec JSON (flags ignored)")
    ap.add_argument("--spec-out", default=None,
                    help="write the resolved spec JSON")
    ap.add_argument("--list-components", action="store_true",
                    help="print every registered component and exit")
    return ap


def spec_from_args(args) -> RunSpec:
    """Resolve CLI flags (including the legacy --compress-ratio derivation)
    into a concrete, serializable RunSpec."""
    if args.spec:
        with open(args.spec) as f:
            return RunSpec.from_json(f.read())
    agg_mode = resolve_agg_mode(args.agg_mode)
    compressor, ckw = args.compressor, dict(args.compressor_kwargs)
    if compressor is None:
        if agg_mode == "sparse_support":
            compressor = "randk"
            ckw = {"ratio": (args.compress_ratio
                             if args.compress_ratio < 1.0 else 0.1),
                   "common_randomness": True, **ckw}
        elif args.compress_ratio < 1.0:
            compressor = "randk"
            ckw = {"ratio": args.compress_ratio, **ckw}
        else:
            compressor = "identity"
    elif compressor == "randk" and "ratio" not in ckw:
        if args.compress_ratio < 1.0:
            ckw["ratio"] = args.compress_ratio
        if agg_mode == "sparse_support":
            ckw.setdefault("common_randomness", True)
    data_kwargs = {"seq_len": args.seq_len,
                   "per_worker_batch": args.per_worker_batch,
                   "reduced": args.reduced,
                   "heterogeneous": args.heterogeneous,
                   "remat": args.remat, **args.data_kwargs}
    return RunSpec(
        task="lm", arch=args.arch, method=args.method,
        n_workers=args.n_workers, n_byz=args.n_byz, attack=args.attack,
        aggregator=args.aggregator, bucket_size=args.bucket_size,
        agg_mode=agg_mode, compressor=compressor, p=args.p, lr=args.lr,
        optimizer=args.optimizer, steps=args.steps, seed=args.seed,
        trace=args.trace, faults=args.faults, fault_guard=args.fault_guard,
        method_kwargs=args.method_kwargs, attack_kwargs=args.attack_kwargs,
        aggregator_kwargs=args.aggregator_kwargs, compressor_kwargs=ckw,
        optimizer_kwargs=args.optimizer_kwargs, data_kwargs=data_kwargs)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from repro_torch.obs import profile
    if args.profile_dir:
        profile.enable_step_markers()
    if args.list_components:
        for kind in ("arch", "method", "attack", "aggregator", "compressor",
                     "optimizer", "agg_mode"):
            print(f"{kind}:")
            for name, summary in describe(kind).items():
                print(f"  {name:<22} {summary}")
        return []
    spec = spec_from_args(args)
    if args.spec_out:
        with open(args.spec_out, "w") as f:
            f.write(spec.to_json())

    exp = build(spec, args.device)
    acfg = exp.arch_cfg
    print(f"[train] {spec.arch} "
          f"({'reduced' if spec.data_kwargs.get('reduced') else 'full'}): "
          f"~{acfg.param_count()/1e6:.1f}M params, method={spec.method}, "
          f"{spec.n_workers} workers ({spec.n_byz} byzantine, "
          f"attack={spec.attack}, agg={exp.cfg.aggregator.name}, "
          f"backend={spec.agg_mode})")
    with profile.profile_trace(args.profile_dir):
        result = exp.run(log_every=args.log_every, verbose=True,
                         checkpoint=args.checkpoint,
                         checkpoint_every=args.checkpoint_every,
                         resume=args.resume,
                         metrics_out=args.metrics_out,
                         metrics_jsonl=args.metrics_out_jsonl)
    if spec.trace and result.traces:
        det = result.detection_summary()
        print(f"[train] detection over {det['rounds']} traced rounds: "
              f"precision {det['precision']:.3f} "
              f"recall {det['recall']:.3f} "
              f"byz_leakage {det['byz_leakage']:.3f}")
    return result.history


if __name__ == "__main__":
    main()
