"""Subprocess worker entry point for the sweep scheduler (port of
``repro/exec/worker.py``).

``python -m repro_torch.exec.worker --spec cell.spec.json --out cell.json``
runs ONE sweep cell in a fresh process and writes the artifact JSON
(``RunResult.to_dict()``) atomically. The scheduler launches it with the
worker's ``CUDA_VISIBLE_DEVICES`` already pinned in the environment, and
the cell's device (``"device"`` in ``--run-kw``; the card when absent)
is the runner's. Exit code 0 means the artifact was written; anything
else (traceback on stderr) is a failed cell the scheduler records and
isolates. Its last line of standard output is one JSON object,
``{"worker_timing": {...}}``: seconds for ``import torch`` and the port,
the CUDA context, building the experiment (the data on the device), the
run (init, torch's first-use imports, the loop), the loop alone, and in
all.

``--fault crash|hang`` is the chaos layer's process-site injection: the
scheduler passes it on a cell's FIRST attempt only, so the retry path
must absorb an abrupt exit (137, before any artifact is written) or a
hang (the pool's timeout reaps it), and the eventual artifact stays
equal to a fault-free run's. Both act before ``import torch``, so a hung
worker holds no CUDA context.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

CRASH_EXIT_CODE = 137     # what a SIGKILLed worker would report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run one sweep cell")
    ap.add_argument("--spec", required=True,
                    help="path to the cell's RunSpec JSON")
    ap.add_argument("--out", required=True,
                    help="artifact path for RunResult.to_dict() JSON")
    ap.add_argument("--run-kw", default="{}",
                    help="JSON dict of loop knobs (log_every, warmup, "
                         "device, ...)")
    ap.add_argument("--fault", choices=("crash", "hang"), default=None,
                    help="injected process fault (the chaos layer)")
    args = ap.parse_args(argv)

    if args.fault == "crash":
        print("repro_torch.faults: injected crash (worker dies before "
              "running)", file=sys.stderr, flush=True)
        return CRASH_EXIT_CODE
    if args.fault == "hang":
        print("repro_torch.faults: injected hang (worker sleeps until "
              "reaped)", file=sys.stderr, flush=True)
        while True:
            time.sleep(3600)

    t0 = time.perf_counter()
    import torch

    from repro_torch.api import RunSpec, build, resolve_device
    t_import = time.perf_counter()
    with open(args.spec) as f:
        spec = RunSpec.from_json(f.read())
    run_kw = json.loads(args.run_kw)
    device = resolve_device(run_kw.pop("device", None))
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    t_cuda = time.perf_counter()
    exp = build(spec, device)
    t_build = time.perf_counter()
    result = exp.run(**run_kw)
    t_run = time.perf_counter()

    payload = result.to_dict()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    tmp = args.out + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, args.out)
    # where the cell's time went, for the scheduler's ledger record
    print(json.dumps({"worker_timing": {
        "import_s": t_import - t0, "cuda_init_s": t_cuda - t_import,
        "build_s": t_build - t_cuda, "run_s": t_run - t_build,
        "loop_s": result.wall_s, "total_s": time.perf_counter() - t0}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
