"""Do the wire's ALIE statistics repeat bit for bit on the card when their
scatter-adds are ``index_add`` (atomic adds) rather than the ordered
``index_put_(accumulate=True)``, and what does each cost?

    PYTHONPATH=src:. python experiments/scatter_repeat.py [--rounds 30]

For each scatter-add (``index_add``, as ``core/wire.wire_stats`` summed
until PR 22; ``index_put``, as ``core/wire._scatter_sum`` sums since):

1. ``wire.wire_stats`` alone on one RandK 0.1 payload at each shape (the
   main path: 5 workers at a9a width; the giant-n tier: 256 workers; a
   qwen3-1.7b q_proj layer: 8 workers x 2^22), called ``--calls`` times:
   whether every call's means and stds equal the first's bit for bit, the
   call's time (CUDA events) and its device time and operations
   (torch.profiler, as ``chip_smoke.timing``).
2. The main cm path (``chip_smoke.MAIN_SPEC``) and rfa at 256 workers
   through ``repro_torch.api.run``, untraced, twice each: whether the
   losses and the final parameters and g^k repeat bit for bit, and ms per
   round (host clock); device operations a round from torch.profiler, the
   count of a run of ``--rounds`` + 5 rounds less that of a run of 5.

Prints the card's name and power limit, then one JSON line a
measurement. Needs a card; a few minutes.
"""
import argparse
import json
import subprocess

import torch

import chip_smoke
from repro_torch import random as R
from repro_torch.api import RunSpec, run
from repro_torch.core import tree_utils as tu
from repro_torch.core import wire


def index_add_sum(d, fi, src):
    return torch.zeros(d, dtype=torch.float32,
                       device=src.device).index_add(0, fi, src)


SCATTERS = {"index_add": index_add_sum, "index_put": wire._scatter_sum}
STATS_SHAPES = [("main path", 5, 123), ("giant-n tier", 256, 123),
                ("qwen3-1.7b q_proj layer", 8, 4_194_304)]
RUN_SPECS = [("cm", dict(chip_smoke.MAIN_SPEC)),
             ("rfa n=256", dict(chip_smoke.MAIN_SPEC,
                                **chip_smoke.GIANT_SPEC, aggregator="rfa"))]


def payload(n, d, dev):
    """A RandK 0.1 wire payload of n workers over the leaf (d,), on the
    main path's shared base, and the good workers' mask."""
    cfg = RunSpec(**{**chip_smoke.MAIN_SPEC, "n_workers": n,
                     "n_byz": max(1, n // 5)}).build_config()
    g = torch.Generator(device=dev).manual_seed(n * 7919 + d)
    base = {"w": torch.randn(d, generator=g, device=dev)}
    delta = {"w": torch.randn(n, d, generator=g, device=dev)}
    qk = tu.per_worker_keys(R.PRNGKey(0, device=dev), n)
    wc = wire.pack_candidates(cfg.compressor, qk, delta, base=base,
                              base_shared=True)
    return wc, ~cfg.byz_mask(dev)


def stats_case(scatter, label, n, d, calls, dev):
    wc, good = payload(n, d, dev)
    first = wire.wire_stats(wc, good)
    same = all(all(torch.equal(a, b) for a, b in zip(
        sum(wire.wire_stats(wc, good), []), sum(first, [])))
        for _ in range(calls))
    t = chip_smoke.timing(lambda: wire.wire_stats(wc, good))
    return {"what": "wire_stats", "scatter": scatter, "case": label, "n": n,
            "d": d, "calls": calls, "repeat_bitwise": same, "ms": t["ms"],
            "device_ms": t["device_ms"], "device_ops": t["device_ops"]}


def device_ops(spec, dev):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(RunSpec(**spec), device=dev)
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def run_case(scatter, label, spec, rounds, dev):
    spec = {**spec, "steps": rounds}
    a = run(RunSpec(**spec), device=dev)
    b = run(RunSpec(**spec), device=dev)
    same = chip_smoke._same_run(a, b)
    long_ops = device_ops({**spec, "steps": rounds + 5}, dev)
    short_ops = device_ops({**spec, "steps": 5}, dev)
    return {"what": "run", "scatter": scatter, "path": label,
            "rounds": rounds, "repeat_bitwise": same,
            "ms_per_round": [r.wall_s / len(r.history) * 1e3
                             for r in (a, b)],
            "device_ops_per_round": (long_ops - short_ops) / rounds}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from repro_torch.kernels import _build
    _build.build()
    run(RunSpec(**{**chip_smoke.MAIN_SPEC, "steps": 2}), device=dev)
    keep = wire._scatter_sum
    try:
        # parent, change, change, parent
        for scatter in ("index_add", "index_put", "index_put", "index_add"):
            wire._scatter_sum = SCATTERS[scatter]
            for label, n, d in STATS_SHAPES:
                print(json.dumps(stats_case(scatter, label, n, d, args.calls,
                                            dev)), flush=True)
            for label, spec in RUN_SPECS:
                print(json.dumps(run_case(scatter, label, spec, args.rounds,
                                          dev)), flush=True)
    finally:
        wire._scatter_sum = keep


if __name__ == "__main__":
    main()
