"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card and times both,
then drives the port's main path — Byz-VR-MARINA with RandK, ALIE and
bucketed coordinate-wise median on a9a-width logistic regression — through
``repro_torch.api.run`` and checks that every aggregation went through the
kernel and that the first rounds agree with the plain CPU path. Any failure
raises and exits non-zero. The last line is the device JSON; the line
before it is the per-kernel JSON. Needs one CUDA card; exits non-zero
without one. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12           # H100 SXM float32 rate outside tensor cores
REPS = 21                        # timed runs per measurement (median taken)
MAIN_STEPS = 300
CPU_CHECK_STEPS = 30
TRAJ_TOL = 2e-5
KERNEL_TOL = 1e-5                # x max|input|: W·x sums in another order

MAIN_SPEC = dict(
    task="logreg", method="marina", n_workers=5, n_byz=1, attack="ALIE",
    aggregator="cm", bucket_size=2, agg_mode="pallas", compressor="randk",
    compressor_kwargs={"ratio": 0.1}, p=0.1, lr=0.5, steps=MAIN_STEPS,
    data_kwargs={"n_samples": 32561, "dim": 123, "batch_size": 32})

# (label, n, d, k or None for the dense load, base rows, bucket s, rule);
# every case carries the ALIE attack on max(1, n // 5) byzantine rows
MAIN_CASES = [
    ("dense", "main path: packed b+w segment", 5, 124, None, 0, 2, "median"),
    ("sparse_wire", "main path: wire, leaf w", 5, 123, 12, 1, 2, "median"),
    ("sparse_wire", "main path: wire, leaf b", 5, 1, 1, 1, 2, "median"),
]
WIDE_CASES = [
    ("dense", "qwen3-1.7b stacked q_proj 28x2048x2048", 8, 117_440_512,
     None, 0, 2, "median"),
    ("sparse_wire", "qwen3-1.7b q_proj layer 2048x2048, RandK 0.1", 8,
     4_194_304, 419_430, 1, 2, "median"),
] + [("dense", f"MAX_FUSED_WORKERS, {rule}, s={s}", 64, 1_048_576, None, 0,
      s, rule) for rule in ("mean", "median", "trimmed") for s in (0, 2)]

REPLACES = {
    "dense": "src/repro/kernels/robust_agg.py:142",
    "sparse_wire": "src/repro/kernels/quantize.py:383",
}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn) -> float:
    """Median over REPS runs of CUDA-event time, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_case(n, d, k, base_rows, s, rule, dev):
    """Inputs of one kernel call, made on the card from a fixed seed."""
    from repro_torch import random as R
    from repro_torch.core.attacks import CoordAttack
    from repro_torch.kernels import norm_agg, quantize
    g = torch.Generator(device=dev).manual_seed(n * 7919 + d)
    mask = torch.arange(n, device=dev) < max(1, n // 5)
    mean = torch.randn(d, device=dev, generator=g)
    std = torch.rand(d, device=dev, generator=g)
    if k is None:
        x = torch.randn(n, d, device=dev, generator=g)
        in_bytes = x.numel() * 4
    else:
        keys = R.fold_in(R.PRNGKey(d, device=dev), torch.arange(n, device=dev))
        idx = torch.sort(R.permutation(keys, d)[:, :k], dim=1).values
        vals = torch.randn(n, k, device=dev, generator=g)
        base = torch.randn(base_rows, d, device=dev, generator=g)
        x = quantize.WireSrc(fmt="sparse", n=n, d=d,
                             arrays=(("vals", vals), ("idx", idx.int())),
                             base=base)
        starts_bytes = n * (math.ceil(d / 128) + 1) * 4
        in_bytes = 8 * n * k + base.numel() * 4 + starts_bytes
    w = None
    if s > 1:
        perm = R.permutation(R.PRNGKey(n, device=dev), n)
        w = norm_agg.bucket_matrix(perm, n, s)
    m = n if w is None else w.shape[0]
    kw = dict(rule=rule, trim=1, attack=CoordAttack("ALIE", 1.06))
    args = (x, w, mask, mean, std)
    bytes_moved = in_bytes + 3 * d * 4            # + mean, std, out
    rule_ops = m if rule == "mean" else m * max(1, math.ceil(math.log2(m)))
    ops = d * (2 + (2 * m * n if w is not None else 0) + rule_ops)
    return args, kw, bytes_moved, ops


def library_call(args, kw):
    """One PyTorch call computing the rule step alone on the already
    attacked and bucketed stack (None for the trimmed mean)."""
    from repro_torch.kernels import quantize
    from repro_torch.kernels.norm_agg import prologue
    x, w, mask, mean, std = args
    xf = quantize.recon(x) if isinstance(x, quantize.WireSrc) else x
    xb = prologue(xf, w, mask, mean, std, kw["attack"])
    if kw["rule"] == "median":
        return lambda: torch.median(xb, dim=0)
    if kw["rule"] == "mean":
        return lambda: torch.mean(xb, dim=0)
    return None


def kernel_case(case, dev):
    from repro_torch.kernels.robust_agg import robust_agg, robust_agg_plain
    kind, label, n, d, k, base_rows, s, rule = case
    args, kw, bytes_moved, ops = make_case(n, d, k, base_rows, s, rule, dev)
    got = robust_agg(*args, **kw)
    want = robust_agg_plain(*args, **kw)
    torch.cuda.synchronize()
    x = args[0]
    scale = max(1.0, float((x.arrays[0][1] if k else x).abs().max()),
                float(args[3].abs().max()) + 1.06 * float(args[4].max()))
    if k:
        scale += float(x.base.abs().max())
    err = float((got - want).abs().max())
    limit = KERNEL_TOL * scale
    if not (got.shape == (d,) and torch.isfinite(got).all()
            and err <= limit):
        raise AssertionError(f"robust_agg {label}: max abs err {err:.3e} > "
                             f"limit {limit:.3e} (or non-finite output)")
    ms = cuda_ms(lambda: robust_agg(*args, **kw))
    plain_ms = cuda_ms(lambda: robust_agg_plain(*args, **kw))
    lib = library_call(args, kw)
    library_ms = None if lib is None else cuda_ms(lib)
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    row = {"kind": kind, "label": label, "n": n, "d": d, "k": k,
           "base_rows": base_rows, "s": s, "rule": rule,
           "max_abs_err": err, "err_limit": limit, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": ("bytes" if bytes_moved / HBM_BYTES_PER_S
                        >= ops / FP32_OPS_PER_S else "operations"),
           "library_ms": library_ms, "bytes": bytes_moved, "ops": ops}
    print(f"[kernel] {kind:11s} {label}: n={n} d={d} k={k} s={s} {rule} | "
          f"max abs err {err:.3e} (limit {limit:.3e}) | kernel {ms:.4f} ms"
          f" plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
          f"({row['bound_by']}) library(rule step alone) "
          f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}",
          flush=True)
    del args, got, want, lib
    torch.cuda.empty_cache()
    return row


def main_path(dev):
    from repro_torch.api import RunSpec, run
    from repro_torch.kernels.robust_agg import robust_agg
    spec = RunSpec(**MAIN_SPEC)
    robust_agg.launches = robust_agg.wire_launches = 0
    t0 = time.time()
    res = run(spec, device=dev, log_every=1)
    wall = time.time() - t0
    launches = robust_agg.launches
    wire_launches = robust_agg.wire_launches
    hist = res.history
    losses = [h["loss"] for h in hist]
    ck = [int(h["c_k"]) for h in hist]
    full = sum(ck)
    vr = len(ck) - full
    for h in hist[::50] + [hist[-1]]:
        print(f"[main] step {h['step']:4d} loss {h['loss']:.6f} "
              f"c_k={int(h['c_k'])}", flush=True)
    per_round_ms = res.wall_s / len(hist) * 1e3
    print(f"[main] {len(hist)} rounds, {full} full (c_k=1), {vr} VR; "
          f"{per_round_ms:.3f} ms per round (host clock, loop only); "
          f"run() wall {wall:.2f} s incl. data and init; "
          f"robust_agg.launches={launches} (wire {wire_launches})",
          flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite loss on the main path")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"final loss {losses[-1]} not below the first "
                             f"{losses[0]}")
    if launches != 1 + full + 2 * vr or wire_launches != 2 * vr:
        raise AssertionError(
            f"robust_agg launched {launches} times ({wire_launches} wire), "
            f"expected {1 + full + 2 * vr} ({2 * vr} wire): an aggregation "
            "bypassed the kernel")
    cpu = run(RunSpec(**{**MAIN_SPEC, "steps": CPU_CHECK_STEPS}),
              device="cpu", log_every=1)
    cpu_ck = [int(h["c_k"]) for h in cpu.history]
    if cpu_ck != ck[:CPU_CHECK_STEPS]:
        raise AssertionError(f"c_k differs from the CPU path: {cpu_ck} vs "
                             f"{ck[:CPU_CHECK_STEPS]}")
    diff = float(np.max(np.abs(np.array(losses[:CPU_CHECK_STEPS])
                               - [h["loss"] for h in cpu.history])))
    print(f"[main] first {CPU_CHECK_STEPS} rounds vs the CPU plain path: "
          f"c_k identical, max |loss diff| {diff:.3e} (limit {TRAJ_TOL})",
          flush=True)
    if not diff <= TRAJ_TOL:
        raise AssertionError(f"loss differs from the CPU path by {diff}")
    return {"launches": launches, "wire_launches": wire_launches,
            "rounds": len(hist), "full_rounds": full,
            "per_round_ms": per_round_ms, "final_loss": losses[-1],
            "first_loss": losses[0], "cpu_loss_diff": diff}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    print(f"[card] {card}", flush=True)
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    for name, log in _build.build().items():
        print(f"[build] {name}.cu ({time.time() - t0:.1f} s):\n{log.strip()}",
              flush=True)
    main_rows = [kernel_case(c, dev) for c in MAIN_CASES]
    wide_rows = [kernel_case(c, dev) for c in WIDE_CASES]
    mp = main_path(dev)
    kernels = []
    for kind in ("dense", "sparse_wire"):
        rows = [r for r in main_rows if r["kind"] == kind]
        launches = (mp["wire_launches"] if kind == "sparse_wire"
                    else mp["launches"] - mp["wire_launches"])
        if launches < 1:
            raise AssertionError(f"robust_agg ({kind}) never ran on the "
                                 "main path")
        kernels.append({
            "name": f"robust_agg ({kind} load)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/robust_agg.cu",
            "replaces": REPLACES[kind], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows) / len(rows),
            "plain_ms": sum(r["plain_ms"] for r in rows) / len(rows),
            "bound_ms": sum(r["bound_ms"] for r in rows) / len(rows),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in rows) else "operations"),
            "library_ms": sum(r["library_ms"] for r in rows) / len(rows)})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "main_cases": main_rows, "wide_cases": wide_rows, "main_path": mp,
         "kernels": kernels}, indent=1))
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
