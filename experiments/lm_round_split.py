"""Where a full-width LM round's time goes, on one CUDA card.

    python3 experiments/lm_round_split.py

Runs ``chip_smoke.LM_SPEC`` (qwen3-1.7b at full width, bfloat16, 5
workers x 4 x 128 tokens, MARINA + RandK 0.1 + ALIE + cm s = 2 on the
kernels) through ``repro_torch.api.run`` for 3 rounds and profiles the
second one with torch.profiler (CPU and CUDA activity): the round's host
time, the device's busy time and idle share, the device ops, and the
ops that take most device time and most host time. Prints a JSON line
and writes it to ``chiprun_out/lm_round_split.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_round_split: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.api import RunSpec, run
    from repro_torch.kernels import _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _build.build()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def cb(it, state, m):
        marks[it] = time.perf_counter()
        if it == 0:
            prof.start()
        elif it == 1:
            torch.cuda.synchronize()
            prof.stop()
        return False

    res = run(RunSpec(**{**chip_smoke.LM_SPEC, "steps": 3}), log_every=1,
              callback=cb, callback_every=1)
    round_ms = (marks[1] - marks[0]) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    table = prof.key_averages()

    def top(key, n=15):
        rows = sorted(table, key=lambda r: getattr(r, key), reverse=True)
        return [{"name": r.key[:80], "count": r.count,
                 "device_ms": r.device_time_total / 1e3,
                 "host_self_ms": r.self_cpu_time_total / 1e3}
                for r in rows[:n]]

    out = {"card": card, "torch": torch.__version__,
           "c_k": [h["c_k"] for h in res.history],
           "profiled_round": 1, "round_ms": round_ms,
           "device_busy_ms": busy_ms, "device_ops": len(dev),
           "idle_share": 1 - busy_ms / round_ms,
           "top_device": top("device_time_total"),
           "top_host": top("self_cpu_time_total")}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "lm_round_split.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
