"""Does the reference's loss fall on each method-zoo path of
``chip_smoke.py``, and at which step size?

    PYTHONPATH=src:. python experiments/path_lr_check.py [--lr 0.5 0.25 ...]
        [--paths "csgd cm" ...]

Runs the JAX reference (``repro.api.run``, on the CPU) on the spec of each
path of ``chip_smoke.ZOO_PATHS`` and ``chip_smoke.ZOO_REST_PATHS`` (MARINA
with dither, natural compression and importance sampling) and on
``chip_smoke.RN_SPEC``, at a9a width and 100 rounds (more than the paths
run), once per step size (and cmfilter on RandK 0.1, which its path does
not take), and prints one JSON line per run: the first, last and least
loss, and whether every loss is finite. ``chip_smoke.py`` takes lr 0.5
where the last loss is below the first; where it is not at 0.5 or 0.25,
the largest of 0.1 and 0.05 at which the last loss is 0.05 below the
first. A minute or two a step size on one CPU core.
"""
import argparse
import json
import math
import time
import warnings

import chip_smoke

from repro.api import RunSpec, run


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[0.5])
    ap.add_argument("--paths", nargs="+", default=None)
    args = ap.parse_args()
    warnings.filterwarnings("ignore")
    specs = {tag: {**chip_smoke.MAIN_SPEC, **over}
             for tag, over, _ in chip_smoke.ZOO_PATHS}
    specs.update({tag: {**chip_smoke.MAIN_SPEC, **over}
                  for tag, over in chip_smoke.ZOO_REST_PATHS})
    specs["marina RN cm"] = dict(chip_smoke.RN_SPEC)
    # cmfilter on the main path's RandK 0.1, which the path does not take
    specs["cmfilter krum randk"] = {**chip_smoke.MAIN_SPEC,
                                    "method": "cmfilter",
                                    "aggregator": "krum"}
    for lr in args.lr:
        for tag, spec in specs.items():
            if args.paths and tag not in args.paths:
                continue
            t0 = time.time()
            res = run(RunSpec(**{**spec, "agg_mode": "gspmd", "lr": lr,
                                 "steps": 100}), log_every=1)
            losses = [h["loss"] for h in res.history]
            print(json.dumps({
                "path": tag, "lr": lr, "first": losses[0],
                "last": losses[-1], "min": min(losses),
                "finite": all(math.isfinite(v) for v in losses),
                "s": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
