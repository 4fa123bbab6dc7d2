"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all at once), holds each against its plain
PyTorch version on the card, checks that the norm, TopK and quantizer
kernels repeat bit for bit, and times kernel, plain version and a library
call: each kernel row has the event window around the call (its
wrapper's host work included), the device time and device operations
per call from torch.profiler, and ``robust_agg``, ``weighted_sum``,
``pair_gram``, ``rfa_iter`` (its public call and the drivers' sq-alone
call), ``weighted_sum_blocked``, ``pair_gram_blocked`` and
``sqdist_to_blocked`` must issue one device operation a call. Then it
drives the port's main path — Byz-VR-MARINA with RandK, ALIE and
bucketing s = 2 on a9a-width logistic regression — through
``repro_torch.api.run`` three times at 5 workers, with coordinate-wise
median, RFA and Krum, and twice at 256 workers (the giant-n tier on the
blocked kernels), with RFA and Krum; Byz-EF21 with TopK on the sparse
wire at gisette width (5000 features, where TopK's select kernel runs);
the block quantizer through the ``repro_torch.kernels.ops`` entry point;
the chaos paths (the fault guard on, NaN gradients and corrupted wire
payloads on worker 4) with cm, RFA and Krum, which run the masked
kernels on dense and wire rounds; and partial participation, at 5
workers with cm (80% sampled) and at 256 with RFA and Krum (75%); the
int8, sign and bf16 wires: MARINA with int8 (cm, RFA and Krum, and cm
under the chaos plan), Byz-EF21 with sign (cm) and with bf16 (cm, and
Krum under the chaos plan); the ``kernels.ops`` entry points on every
wire format and on a bfloat16 stack; and the method zoo at the main
path's shape (sgd, sgdm, mvr, saga, and csgd and diana on the RandK wire,
with cm; svrg with RFA; cmfilter on the TopK wire with Krum) and MARINA
under the RN attack, which diverges as the reference does;
sparse-support MARINA (which launches no kernel, as the reference runs
no kernel there), MARINA with dither, natural compression and importance
sampling; the traced twins of seven paths (their launches and
trajectories equal to the untraced runs', bit for bit, their traces held
to the CPU path's) and three rounds under ``obs.profile.profile_trace``;
and the exec phase: a cm run checkpointed and resumed (equal to the
uninterrupted run bit for bit, its checkpoint equal on the CPU), the
warm-up step (equal bit for bit), a sweep of cm, RFA and Krum over two
seeds through ``run_sweep`` and two worker subprocesses pinned to the
card, with an injected crash and hang retried (each artifact equal to an
in-process run), resumed after an artifact is lost (the summary's bytes
kept), and a gspmd seed group equal to its serial runs; and the serve
phase: every fused kernel with the streaming service's staleness weights
in W, timed beside the same call unweighted, and the service (``ServeSpec(...).run()``) with cm, traced and
untraced Krum, the K = 256 cell on the blocked kernels, the sync limit
(bit for bit with ``api.run``) and a killed run resumed from its
checkpoint, each with its launches per fire and its first fires against
the CPU run; and the LM phase: robust_agg's bfloat16 load at the LM
leaves' widths (8 x 352 M, past 2^31 elements, and the path's 5-worker
leaves) against its plain version, the reduced float32 qwen3-1.7b twin
against the CPU path, and qwen3-1.7b at full width (28 layers, bfloat16,
5 workers x 4 x 128 tokens, MARINA + RandK + ALIE + cm) through
``api.run`` and ``launch.train.main``: its launches a round, ms a round,
tokens a second and peak memory, its first rounds again bit for bit, and
one round's aggregation held leaf by leaf to the plain versions; and the
MLA and MoE phase: robust_agg's bfloat16 load at the widest expert
stacks (5 x 553,648,128, past 2^31 elements, and 5 x 419,430,400), the
reduced float32 twins of deepseek-v2-lite-16b and phi3.5-moe-42b-a6.6b
against the CPU path, and deepseek-v2-lite-16b at its published widths,
cut to 3 of its 27 layers (registered here as deepseek-v2-lite-16b-3l),
checked as qwen3-1.7b is; and the SSD and RG-LRU phase: robust_agg's
bfloat16 load at recurrentgemma-2b's embedding (5 x 655,360,000), the
reduced float32 twins of mamba2-130m and recurrentgemma-2b against the
CPU path, mamba2-130m at full width (24 layers, no cut) through
``api.run`` and ``launch.train.main``, and recurrentgemma-2b at its
published widths cut to 8 of its 26 layers (registered here as
recurrentgemma-2b-8l), checked as qwen3-1.7b is. Each LM phase ends by
decoding on its last full-width run's parameters through
``launch.serve.generate`` (greedy, 4 sequences, a 16-token prompt, 32
generated): ms a decode step, tokens a second, peak memory, no kernel
launch, the timed call equal to the warm one bit for bit, and (but for
the MoE model, whose capacity counts a step's tokens) float32 decode
against the float32 forward; the reduced float32 twin's decode against
the CPU path; and ``launch.serve.main`` at its defaults. The chaos
phase runs the port's ``launch.chaos.main(["--smoke"])`` on the card:
a GREEN report, each cell's launches exact and each cell held to the
same cell on the CPU.
The masked kernels (``valid`` in the
load, the masked coordinate rule) are held to their plain versions beside
the unmasked ones, and so is every load (dense float32 or bfloat16, the
sparse, int8, sign and bf16 wires) in each fused kernel. It checks that
every aggregation and selection went through the kernels (launch counts
against each path's formula) and that the first rounds agree with the
plain CPU path, profiles a few rounds of five paths (device busy time and
operations a round), and holds the sparse wire's range search on the
card to its plain twin. Any failure raises and exits
non-zero. The last line is the device JSON; the line before it is the
per-kernel JSON. Needs one CUDA card; exits non-zero without one.
Imports nothing of JAX.
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
TF32_OPS_PER_S = 495e12          # H100 SXM dense TF32 rate of the tensor cores
REPS = 21                        # timed runs per measurement (median taken)
# the plain versions and library calls of a case of SLOW_ELEMENTS stacked
# elements or more (0.03-0.5 s a call) are timed over SLOW_REPS runs; the
# kernels' own calls always over REPS
SLOW_ELEMENTS = 1 << 28
SLOW_REPS = 3
# idle time on each side of a profiled window: the tracer stamps device
# activity on a clock that sits up to milliseconds off the host's (3.6 ms
# early seen on the H100) and drops what falls outside its window, which
# lost most of the events of a few-microsecond kernel's 21 calls
PROFILE_PAD_S = 0.05
# profiles of a kernel row at most: in a whole run of this script with up
# to five, 55 of 160 rows took all five windows and 52 of them never kept
# every event, so windows four and five bought little and cost some 40 s
PROFILE_TRIES = 3
# rounds of each main path: with the kernel phases, the paths and their
# CPU checks, the script has to end inside 1200 s on a slow host too. The
# CPU checks cost most at 256 workers (the logistic loss over the whole
# a9a anchor at the init and at each full round); their 4 rounds are 3 VR
# rounds and the first full round (the main spec's coin first comes up at
# round 3), which a MARINA path's check must hold
MAIN_STEPS = 20
CPU_CHECK_STEPS = 4
TRAJ_TOL = 2e-5
# the paths of a compressor that rounds (int8 levels, signs, bf16): the
# card's gradients and its sums over d take another order than the CPU's,
# and a coordinate within that rounding of a step takes the neighbouring
# value (a level, norm/127; the other sign, 2·scale; a bf16 ulp), a jump
# that moves later losses by ~1e-5 (2.8e-5 seen on MARINA + int8 with RFA)
QUANT_TRAJ_TOL = 1e-4
KERNEL_TOL = 1e-5                # x max|input|: W·x sums in another order
SUM_TOL = 1e-5                   # x the largest entry: sums over d in
                                 # another order (blocked kernels: always)
WIDE_SUM_TOL = 1e-4              # the fused norm kernels at d > 1e6

MAIN_SPEC = dict(
    task="logreg", method="marina", n_workers=5, n_byz=1, attack="ALIE",
    aggregator="cm", bucket_size=2, agg_mode="pallas", compressor="randk",
    compressor_kwargs={"ratio": 0.1}, p=0.1, lr=0.5, steps=MAIN_STEPS,
    data_kwargs={"n_samples": 32561, "dim": 123, "batch_size": 32})
# the giant-n tier: 256 workers, 32 byzantine; bucketing leaves m = 128
# rows, so RFA and Krum run on the blocked kernels
GIANT_SPEC = dict(n_workers=256, n_byz=32)
# the chaos paths: the fault guard on, and worker 4's gradients NaN and its
# wire payload bit-flipped, each in 20% of the rounds
CHAOS_SPEC = dict(fault_guard=True, faults={"seed": 0, "faults": [
    {"kind": "nan_grad", "prob": 0.2, "workers": [4]},
    {"kind": "corrupt_wire", "prob": 0.2, "workers": [4]}]})
PART_SPEC = dict(participation=0.8)           # 4 of 5 workers a round
GIANT_PART_SPEC = dict(GIANT_SPEC, participation=0.75)  # 192 of 256
# Byz-EF21 with TopK on the sparse wire at the width of LIBSVM's
# gisette_scale (6000 samples x 5000 features, NIPS 2003 feature
# selection): leaf w is wider than two 2048-column tiles, so every round
# launches TopK's select kernel; the reference's loss falls at lr 0.5
EF21_SPEC = dict(
    task="logreg", method="byz_ef21", n_workers=5, n_byz=1, attack="ALIE",
    aggregator="cm", bucket_size=2, agg_mode="pallas", compressor="topk",
    compressor_kwargs={"ratio": 0.1}, lr=0.5, steps=MAIN_STEPS,
    data_kwargs={"n_samples": 6000, "dim": 5000, "batch_size": 32})
# the dense wires: MARINA with int8 (blockwise ℓ2 dithering, one norm per
# 256 coordinates) at a9a width; Byz-EF21 with sign and with bf16 at
# gisette width
# the method zoo at the main path's shape and attack: (tag, what differs
# from MAIN_SPEC, the load of its aggregations). lr 0.5 where the
# reference's loss falls over 100 rounds on the CPU; where it does
# not at 0.5 or 0.25, the largest of 0.1 and 0.05 at which it falls by
# 0.05 (csgd, diana: RandK 0.1 uploads without variance reduction).
# cmfilter takes TopK 0.1: its mirrored momenta u_i <- u_i + Q(m_i - u_i)
# grow without bound under RandK's d/K scaling (the reference's loss
# reaches 1e32 at every lr), as EF21's do (experiments/path_lr_check.py)
ZOO_PATHS = [
    ("sgd cm", dict(method="sgd"), "dense"),
    ("sgdm cm", dict(method="sgdm"), "dense"),
    ("csgd cm", dict(method="csgd", lr=0.1), "sparse"),
    ("diana cm", dict(method="diana", lr=0.05), "sparse"),
    ("mvr cm", dict(method="mvr"), "dense"),
    ("svrg rfa", dict(method="svrg", aggregator="rfa"), "dense"),
    ("cmfilter krum", dict(method="cmfilter", aggregator="krum",
                           compressor="topk"), "sparse"),
    ("saga cm", dict(method="saga", method_kwargs={"batch_size": 16}),
     "dense"),
]
# MARINA under RN (scale 10): Alg. 2 fills the sixth row of 5 workers'
# buckets with their mean, noise included, so two of cm's three buckets
# carry noise and the reference's loss grows at lr 0.5 to 0.05
RN_SPEC = dict(MAIN_SPEC, attack="RN")
# the rest of the zoo at the main path's shape: (tag, what differs from
# MAIN_SPEC). MARINA with the dense compressors (no wire: every VR round
# is one dense robust_agg) and with importance sampling (RandK's wire as
# on the main path); lrs from experiments/path_lr_check.py, as ZOO_PATHS'
ZOO_REST_PATHS = [
    ("marina dither cm", dict(compressor="dither", compressor_kwargs={},
                              lr=0.5)),
    ("marina natural cm", dict(compressor="natural", compressor_kwargs={},
                               lr=0.5)),
    ("marina importance cm", dict(data_kwargs={
        **MAIN_SPEC["data_kwargs"], "sampling": "importance"})),
]
# sparse-support MARINA: common-randomness RandK, so every worker sends
# the same K coordinates and the VR rounds aggregate the support alone
SPARSE_SPEC = dict(MAIN_SPEC, agg_mode="sparse_support", compressor_kwargs={
    "ratio": 0.1, "common_randomness": True})
INT8_SPEC = dict(MAIN_SPEC, compressor="int8", compressor_kwargs={})
SIGN_SPEC = dict(EF21_SPEC, compressor="sign", compressor_kwargs={})
BF16_SPEC = dict(EF21_SPEC, compressor="bf16", compressor_kwargs={})

# (label, n, d, k or None for the dense load, base rows, bucket s, rule);
# every case carries the ALIE attack on max(1, n // 5) byzantine rows
MAIN_CASES = [
    ("dense", "main path: packed b+w segment", 5, 124, None, 0, 2, "median"),
    ("sparse_wire", "main path: wire, leaf w", 5, 123, 12, 1, 2, "median"),
    ("sparse_wire", "main path: wire, leaf b", 5, 1, 1, 1, 2, "median"),
    ("dense", "Byz-EF21 init: leaf w", 5, 5000, None, 0, 2, "median"),
    ("dense", "Byz-EF21 init: leaf b", 5, 1, None, 0, 2, "median"),
    ("sparse_wire", "Byz-EF21 wire, leaf w, per-worker base", 5, 5000, 500,
     5, 2, "median"),
    ("sparse_wire", "Byz-EF21 wire, leaf b, per-worker base", 5, 1, 1, 5, 2,
     "median"),
]
WIDE_CASES = [
    ("dense", "qwen3-1.7b stacked q_proj 28x2048x2048", 8, 117_440_512,
     None, 0, 2, "median"),
    ("sparse_wire", "qwen3-1.7b q_proj layer 2048x2048, RandK 0.1", 8,
     4_194_304, 419_430, 1, 2, "median"),
] + [("dense", f"MAX_FUSED_WORKERS, {rule}, s={s}", 64, 1_048_576, None, 0,
      s, rule) for rule in ("mean", "median", "trimmed") for s in (0, 2)]

# the masked kernels' cases (the fault guard's and participation's load and
# rule): (kind, label, n, d, k, base rows, s, rule, invalid workers). The
# bucket operator is the masked one over the identity permutation, so the
# last workers share the last buckets: n = 8 with 6 and 7 invalid drops a
# whole bucket; invalid rows hold NaN, which the load must keep out.
MASKED_MAIN_CASES = [
    ("dense", "chaos path: packed b+w segment, worker 4 invalid", 5, 124,
     None, 0, 2, "median", (4,)),
    ("sparse_wire", "chaos path: wire, leaf w, worker 4 invalid", 5, 123, 12,
     1, 2, "median", (4,)),
    ("sparse_wire", "chaos path: wire, leaf b, worker 4 invalid", 5, 1, 1, 1,
     2, "median", (4,)),
]
MASKED_WIDE_CASES = [
    ("dense", "qwen3-1.7b stacked q_proj, workers 6 and 7 invalid (a bucket"
     " dropped)", 8, 117_440_512, None, 0, 2, "median", (6, 7)),
    ("sparse_wire", "qwen3-1.7b q_proj layer, RandK 0.1, worker 7 invalid",
     8, 4_194_304, 419_430, 1, 2, "median", (7,)),
]

REPLACES = {
    "dense": "src/repro/kernels/robust_agg.py:142",
    "sparse_wire": "src/repro/kernels/quantize.py:383",
    "int8": "src/repro/kernels/quantize.py:390",
    "sign": "src/repro/kernels/quantize.py:397",
    "bf16": "src/repro/kernels/quantize.py:399",
    "dense_bf16": "src/repro/kernels/norm_agg.py:172",
    "masked": "src/repro/kernels/robust_agg.py:69",
    "pair_gram": "src/repro/kernels/norm_agg.py:220",
    "rfa_iter": "src/repro/kernels/norm_agg.py:262",
    "weighted_sum": "src/repro/kernels/norm_agg.py:297",
    "pair_gram_blocked": "src/repro/kernels/norm_agg.py:480",
    "sqdist_to_blocked": "src/repro/kernels/norm_agg.py:515",
    "weighted_sum_blocked": "src/repro/kernels/norm_agg.py:549",
    "topk_select": "src/repro/kernels/quantize.py:195",
    "block_quantize": "src/repro/kernels/quantize.py:88",
}

# the loads of the dense wires and of the bfloat16 stack, held in each
# fused kernel at the main paths' shapes and at full width, unmasked and
# masked: (kind, label, n, d, k (None), base rows, s, rule); the base is
# MARINA's shared g (1 row) for int8, Byz-EF21's g_i (n rows) for sign
# and bf16
NEW_LOADS = ("int8", "sign", "bf16", "dense_bf16")
LOAD_MAIN_CASES = [
    ("int8", "MARINA int8 wire, leaf w (a9a width)", 5, 123, None, 1, 2,
     "median"),
    ("int8", "MARINA int8 wire, leaf b", 5, 1, None, 1, 2, "median"),
    ("sign", "Byz-EF21 sign wire, leaf w (gisette width)", 5, 5000, None, 5,
     2, "median"),
    ("sign", "Byz-EF21 sign wire, leaf b", 5, 1, None, 5, 2, "median"),
    ("bf16", "Byz-EF21 bf16 wire, leaf w (gisette width)", 5, 5000, None, 5,
     2, "median"),
    ("bf16", "Byz-EF21 bf16 wire, leaf b", 5, 1, None, 5, 2, "median"),
    ("dense_bf16", "ops entry: bf16 stack (gisette width)", 5, 5000, None,
     0, 2, "median"),
]
LOAD_WIDE_CASES = [
    ("int8", "qwen3-1.7b q_proj layer 2048x2048, int8 wire, shared base", 8,
     1 << 22, None, 1, 2, "median"),
    ("sign", "qwen3-1.7b q_proj layer 2048x2048, sign wire, per-worker "
     "base", 8, 1 << 22, None, 8, 2, "median"),
    ("bf16", "qwen3-1.7b q_proj layer 2048x2048, bf16 wire, per-worker "
     "base", 8, 1 << 22, None, 8, 2, "median"),
]
# the bf16 stack at full width goes through robust_agg alone
LOAD_BF16_STACK_CASE = ("dense_bf16", "qwen3-1.7b stacked q_proj "
                        "28x2048x2048, bf16 stack", 8, 117_440_512, None, 0,
                        2, "median")
LOAD_MASKED_MAIN_CASES = [c + ((4,),) for c in LOAD_MAIN_CASES]
LOAD_MASKED_WIDE_CASES = [c + ((7,),) for c in LOAD_WIDE_CASES]
# the ops entry points on every wire format and on a bf16 stack, at
# gisette width: (format, base rows)
OPS_WIRES = [("int8", 1), ("sign", 5), ("bf16", 5)]
OPS_RULES = ("median", "rfa", "krum")

# the norm kernels' cases: (kind, label, n, d, k or None, base rows, s);
# ALIE on max(1, n // 5) rows as above
NORM_MAIN_CASES = [c[:7] for c in MAIN_CASES[:3]]
NORM_WIDE_CASES = [c[:7] for c in WIDE_CASES[:2]] + [
    ("dense", f"MAX_FUSED_WORKERS, s={s}", 64, 1_048_576, None, 0, s)
    for s in (0, 2)]
NORM_KERNELS = ("pair_gram", "rfa_iter", "weighted_sum")
BLOCKED_KERNELS = ("pair_gram_blocked", "sqdist_to_blocked",
                   "weighted_sum_blocked")
# the blocked kernels' cases: (label, m, d) of a dense (m, d) stack
BLOCKED_MAIN_CASES = [
    ("giant-n main path: leaf w", 128, 123),
    ("giant-n main path: leaf b", 128, 1),
]
BLOCKED_WIDE_CASES = [
    ("n=256 at s=2, one qwen3-1.7b q_proj layer 2048x2048", 128, 1 << 22),
    ("m=1024, d=2^20", 1024, 1 << 20),
    ("m=4096 (the reference bench's largest n), d=2^16", 4096, 1 << 16),
]
# TopK's cases: (label, rows, d, k); k = max(int(0.1 d), 1)
TOPK_MAIN_CASES = [("Byz-EF21 main path: leaf w (gisette width)", 5, 5000,
                    500)]
TOPK_WIDE_CASES = [
    ("qwen3-1.7b q_proj layer 2048x2048, TopK 0.1", 8, 1 << 22, 419_430),
    ("qwen3-1.7b stacked q_proj 28x2048x2048, TopK 0.1", 1, 117_440_512,
     11_744_051),
]
# the block quantizer's cases, through ops.block_quantize: (label, d)
QUANT_LEVELS = 4
QUANT_CASES = [("qwen3-1.7b q_proj layer 2048x2048", 1 << 22),
               ("qwen3-1.7b stacked q_proj 28x2048x2048", 117_440_512)]
NO_LIBRARY = {"rfa_iter": "no single PyTorch call computes z = wᵀ·xb and "
                          "the distances of the rows to it",
              "robust_agg (masked)": "no single PyTorch call computes the "
                                     "masked median over W·x; "
                                     "torch.nanmedian returns the lower "
                                     "median and has no fill rank",
              "block_quantize": "no single PyTorch call computes the "
                                "block norms and the dithered levels"}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS) -> float:
    """Median over ``reps`` runs of CUDA-event time, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def plain_reps(elements) -> int:
    """Timed runs of a plain version or library call over ``elements``
    stacked elements: SLOW_REPS from SLOW_ELEMENTS on, else REPS."""
    return SLOW_REPS if elements >= SLOW_ELEMENTS else REPS


def device_profile(fn):
    """(device ms, device operations, their names) per steady-state call
    of ``fn``: torch.profiler's CUDA activity over REPS calls after a
    warm-up, every kernel, memcpy and memset the calls issue, their device
    time summed. (None, None, []) where the profiler records no device
    activity (the time is then the event window's alone)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(REPS):
            fn()
            torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    evts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evts:
        return None, None, []
    us = sum(e.time_range.elapsed_us() for e in evts)
    return (us / 1e3 / REPS, len(evts) / REPS,
            sorted({e.name[:60] for e in evts}))


def tracer_probe(dev, card) -> dict:
    """Why PROFILE_PAD_S: the events the tracer keeps of REPS calls of a
    one-kernel function (a few µs), 20 windows each, scheduled as before
    the pad (a waiting and a warm-up step, no idle time) and padded
    (``device_profile``), and the offset of the tracer's device clock
    against the host's in 5 windows: each kernel's start less its
    launch's (µs; below 0, device activity is stamped early)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    x = torch.ones(1024, device=dev)

    def fn():
        x.mul_(1.0)

    def scheduled():
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=1, warmup=1, active=REPS)) as p:
            for _ in range(2 + REPS):
                fn()
                torch.cuda.synchronize()
                p.step()
        return sum(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in p.events())

    def offsets():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            time.sleep(PROFILE_PAD_S)
            for _ in range(REPS):
                fn()
                torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        launch, start = {}, {}
        for e in p.profiler.kineto_results.events():
            if e.name() in ("cudaLaunchKernel", "cuLaunchKernel"):
                launch[e.correlation_id()] = e.start_ns()
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                start[e.correlation_id()] = e.start_ns()
        gaps = sorted((start[c] - launch[c]) / 1e3
                      for c in start if c in launch)
        return [gaps[0], gaps[len(gaps) // 2]] if gaps else None

    out = {"calls": REPS,
           "scheduled": [scheduled() for _ in range(20)],
           "padded": [round(device_profile(fn)[1] * REPS)
                      for _ in range(20)],
           "offset_us_min_median": [offsets() for _ in range(5)]}
    print(f"[tracer] events kept of {REPS} calls, offsets: "
          f"{json.dumps(out)} [{card}]", flush=True)
    return out


def timing(fn) -> dict:
    """The times of one kernel row: ``ms`` the event window around the
    call (host work of the wrapper included), ``device_ms`` and
    ``device_ops`` the profiler's device time and operations per call. A
    window where the tracer kept fewer events than there were calls, or
    none (before its window was padded, PROFILE_PAD_S, it lost some in
    some windows, at times several in a row), is profiled again, up to
    PROFILE_TRIES times (``profile_tries``), and the window that kept the
    most events is reported."""
    ms = cuda_ms(fn)
    best = (None, None, [])
    for tries in range(1, PROFILE_TRIES + 1):
        got = device_profile(fn)
        if got[1] is not None and (best[1] is None or got[1] > best[1]):
            best = got
        if best[1] is not None and best[1] >= 1:
            break
    dev_ms, ops, names = best
    return {"ms": ms, "device_ms": dev_ms, "device_ops": ops,
            "device_op_names": names, "profile_tries": tries}


def timing_text(t) -> str:
    dev = ("device not measured (no profiler activity)"
           if t["device_ms"] is None else
           f"device {t['device_ms']:.4f} ms in {t['device_ops']:g} device "
           f"ops/call")
    return f"call {t['ms']:.4f} ms, {dev}"


def make_inputs(n, d, k, base_rows, s, dev, kind=None, weighted=False):
    """(x, w, mask, mean, std) of one kernel call, made on the card from a
    fixed seed, and the bytes of x: the dense stack (float32, or bfloat16
    for ``kind="dense_bf16"``), or the wire payload (sparse when k is
    given, else of ``kind``: int8, sign or bf16, packed from random rows;
    the int8 levels counted over d, their padding unread) and its base.
    ``weighted``: W carries the streaming service's staleness weights,
    W_bucket · diag(w), or diag(w) (m = n) without bucketing, as
    ``sharded_agg._bucket_operator`` builds it."""
    from repro_torch import random as R
    from repro_torch.kernels import norm_agg, quantize
    g = torch.Generator(device=dev).manual_seed(n * 7919 + d)
    mask = torch.arange(n, device=dev) < max(1, n // 5)
    mean = torch.randn(d, device=dev, generator=g)
    std = torch.rand(d, device=dev, generator=g)
    if kind in ("int8", "sign", "bf16"):
        rows = torch.randn(n, d, device=dev, generator=g)
        keys = R.fold_in(R.PRNGKey(d, device=dev),
                         torch.arange(n, device=dev))
        pay = quantize.PACK[kind](keys, rows)
        base = torch.randn(base_rows, d, device=dev, generator=g)
        x = quantize.WireSrc(fmt=kind, n=n, d=d, arrays=tuple(pay.items()),
                             base=base)
        value_bytes = {"int8": 1, "sign": 1, "bf16": 2}[kind]
        side = {"int8": n * -(-d // 256) * 4, "sign": n * 4, "bf16": 0}[kind]
        in_bytes = n * d * value_bytes + side + base.numel() * 4
        del rows
    elif k is None:
        x = torch.randn(n, d, device=dev, generator=g)
        if kind == "dense_bf16":
            x = x.bfloat16()
        in_bytes = x.numel() * x.element_size()
    else:
        keys = R.fold_in(R.PRNGKey(d, device=dev), torch.arange(n, device=dev))
        idx = torch.sort(R.permutation(keys, d)[:, :k], dim=1).values
        vals = torch.randn(n, k, device=dev, generator=g)
        base = torch.randn(base_rows, d, device=dev, generator=g)
        x = quantize.WireSrc(fmt="sparse", n=n, d=d,
                             arrays=(("vals", vals), ("idx", idx.int())),
                             base=base)
        in_bytes = 8 * n * k + base.numel() * 4
    w = None
    if s > 1:
        perm = R.permutation(R.PRNGKey(n, device=dev), n)
        w = norm_agg.bucket_matrix(perm, n, s)
    if weighted:
        from repro_torch.serve import staleness_weights
        tau = np.random.default_rng(n * 7919 + d).integers(0, 6, size=n)
        stale = torch.as_tensor(staleness_weights(tau), device=dev)
        w = torch.diag(stale) if w is None else w * stale[None, :]
    return (x, w, mask, mean, std), in_bytes


def make_case(n, d, k, base_rows, s, rule, dev, kind=None, weighted=False):
    """Inputs of one robust_agg call, its bytes and operations."""
    from repro_torch.core.attacks import CoordAttack
    args, in_bytes = make_inputs(n, d, k, base_rows, s, dev, kind, weighted)
    w = args[1]
    m = n if w is None else w.shape[0]
    kw = dict(rule=rule, trim=1, attack=CoordAttack("ALIE", 1.06))
    bytes_moved = in_bytes + 3 * d * 4            # + mean, std, out
    rule_ops = m if rule == "mean" else m * max(1, math.ceil(math.log2(m)))
    ops = d * (2 + (2 * m * n if w is not None else 0) + rule_ops)
    return args, kw, bytes_moved, ops


def library_call(args, kw):
    """One PyTorch call computing the rule step alone on the already
    attacked and bucketed stack (None for the trimmed mean)."""
    from repro_torch.kernels import norm_agg as N
    x, w, mask, mean, std = args
    xb = N.prologue(N.stack(x), w, mask, mean, std, kw["attack"], None,
                    N.cand_dtype(x))
    if kw["rule"] == "median":
        return lambda: torch.median(xb, dim=0)
    if kw["rule"] == "mean":
        return lambda: torch.mean(xb, dim=0)
    return None


def mask_inputs(args, n, s, invalid):
    """The masked twin of a case's (x, W, mask, mean, std): the invalid
    workers' rows (the dense stack, or the wire's values) set to NaN in
    place, the masked bucket operator over the identity permutation and
    the validity masks -> (x, W, mask, mean, std, valid, bvalid). On a
    wire every float array is poisoned (values, norms, scale)."""
    from repro_torch.faults.guard import masked_bucket_matrix
    from repro_torch.kernels import quantize
    x, _, mask, mean, std = args
    valid = torch.ones(n, dtype=torch.bool, device=mask.device)
    valid[list(invalid)] = False
    rows = ([a for _, a in x.arrays if a.is_floating_point()]
            if isinstance(x, quantize.WireSrc) else [x])
    for a in rows:
        a[~valid] = float("nan")
    if s <= 1:
        return x, None, mask, mean, std, valid, valid
    w, bvalid = masked_bucket_matrix(torch.arange(n, device=mask.device), n,
                                     s, valid)
    return x, w, mask, mean, std, valid, bvalid


def kernel_case(case, dev, weighted=False):
    """``robust_agg`` on one case against its plain version, timed beside
    it and a library call. A masked case (a last element naming invalid
    workers) must equal its plain version (``torch.equal``: both read a
    rank as 0 + v); an unmasked one agree to KERNEL_TOL, since its W·x
    sums in another order. ``weighted`` as in ``make_inputs``."""
    from repro_torch.kernels.robust_agg import robust_agg, robust_agg_plain
    from repro_torch.kernels.norm_agg import stack
    kind, label, n, d, k, base_rows, s, rule, *rest = case
    invalid = rest[0] if rest else ()
    args, kw, bytes_moved, ops = make_case(n, d, k, base_rows, s, rule, dev,
                                           kind, weighted)
    if invalid:
        args = mask_inputs(args, n, s, invalid)
        bytes_moved += 4 * (n + (n if args[1] is None else args[1].shape[0]))
    got = robust_agg(*args, **kw)
    want = robust_agg_plain(*args, **kw)
    torch.cuda.synchronize()
    x = args[0]
    if invalid:
        err = float((got - want).abs().max())
        limit = 0.0
        ok = torch.equal(got, want)
    else:
        scale = max(1.0, float(stack(x).abs().max()),
                    float(args[3].abs().max()) + 1.06 * float(args[4].max()))
        err = float((got - want).abs().max())
        limit = KERNEL_TOL * scale
        ok = err <= limit
    if not (got.shape == (d,) and torch.isfinite(got).all() and ok):
        raise AssertionError(f"robust_agg {label}: max abs err {err:.3e} > "
                             f"limit {limit:.3e} (or non-finite output)")
    # the plain version's float32 and float64 copies of a 5 x 655 M stack
    # fill most of the card: nothing of the check stays alive past it
    del got, want
    torch.cuda.empty_cache()
    t = timing(lambda: robust_agg(*args, **kw))
    reps = plain_reps(n * d)
    plain_ms = cuda_ms(lambda: robust_agg_plain(*args, **kw), reps)
    lib = None if invalid else library_call(args, kw)
    library_ms = None if lib is None else cuda_ms(lib, reps)
    bound_ms, bound_by = bound_of(bytes_moved, ops)
    row = {"kernel": "robust_agg", "kind": kind, "label": label, "n": n,
           "d": d, "k": k, "base_rows": base_rows, "s": s, "rule": rule,
           "weighted": weighted, "m": n if args[1] is None
           else args[1].shape[0],
           "invalid": list(invalid), "max_abs_err": err, "err_limit": limit,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "bytes": bytes_moved, "ops": ops, **t}
    check = ("equal to the plain version" if invalid else
             f"max abs err {err:.3e} (limit {limit:.3e})")
    print(f"[kernel] {kind:11s} {label}: n={n} d={d} k={k} s={s} {rule}"
          f"{' masked' if invalid else ''}"
          f"{' weighted m=' + str(row['m']) if weighted else ''} | {check} "
          f"| kernel "
          f"{timing_text(t)}; plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
          f"({row['bound_by']}) library(rule step alone) "
          f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}",
          flush=True)
    del args, lib
    torch.cuda.empty_cache()
    return row


def bound_of(bytes_moved, ops, rate=FP32_OPS_PER_S):
    """(ms, what bounds it): the least time for these bytes and operations
    (at ``rate`` operations a second: float32 outside the tensor cores
    unless named) on the card."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = ops / rate
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def norm_case(case, dev, weighted=False):
    """Each norm kernel on one case: against its plain version, twice for
    bit-for-bit repeatability, and timed beside its plain version and a
    library call. Returns one row per kernel. ``weighted`` as in
    ``make_inputs``."""
    from repro_torch.core.attacks import CoordAttack
    from repro_torch.kernels import norm_agg as N
    kind, label, n, d, k, base_rows, s, *rest = case
    invalid = rest[0] if rest else ()
    args, in_bytes = make_inputs(n, d, k, base_rows, s, dev, kind, weighted)
    valid = None
    if invalid:
        x, w, mask, mean, std, valid, _ = mask_inputs(args, n, s, invalid)
        in_bytes += 4 * n
    else:
        x, w, mask, mean, std = args
    alie = CoordAttack("ALIE", 1.06)
    m = n if w is None else w.shape[0]
    g = torch.Generator(device=dev).manual_seed(m)
    wr = torch.rand(m, device=dev, generator=g) + 0.1
    wr = wr / wr.sum()
    wn = wr if w is None else wr @ w                   # w_eff, as the drivers
    sent = N.prologue(N.stack(x), None, mask, mean, std, alie, valid,
                      N.cand_dtype(x))
    xb = sent if w is None else w @ sent
    scale = max(1.0, float(sent.abs().max()))
    sum_tol = WIDE_SUM_TOL if d > 1_000_000 else SUM_TOL
    base_bytes = in_bytes + 2 * d * 4                   # + mean, std
    w_ops = 2 + (2 * m * n if w is not None else 0)     # forge, W·x
    spec = {
        "pair_gram": (
            lambda: N.pair_gram(x, w, mask, mean, std, valid, attack=alie),
            lambda: N.pair_gram_plain(x, w, mask, mean, std, valid,
                                      attack=alie),
            lambda: torch.matmul(xb, xb.T),
            base_bytes + m * m * 4, d * (w_ops + m * (m + 1))),
        "rfa_iter": (      # sq alone (RFA's driver) below: no z written
            lambda: N.rfa_iter(x, wr, w, mask, mean, std, valid,
                               attack=alie),
            lambda: N.rfa_iter_plain(x, wr, w, mask, mean, std, valid,
                                     attack=alie),
            None, base_bytes + 2 * m * 4 + d * 4, d * (w_ops + 5 * m)),
        "weighted_sum": (
            lambda: N.weighted_sum(x, wn, mask, mean, std, valid,
                                   attack=alie),
            lambda: N.weighted_sum_plain(x, wn, mask, mean, std, valid,
                                         attack=alie),
            lambda: torch.mv(sent.T, wn),
            base_bytes + n * 4 + d * 4, d * (2 + 2 * n)),
    }
    rows = []
    for name, (kern, plain, lib, bytes_moved, ops) in spec.items():
        first, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        if name == "rfa_iter":
            repeat = all(torch.equal(a, b) for a, b in zip(first, again))
            errs = [float((first[0] - want[0]).abs().max()),
                    float((first[1] - want[1]).abs().max())]
            limits = [KERNEL_TOL * scale,
                      sum_tol * max(1.0, float(want[1].max()))]
            ok = all(torch.isfinite(t).all() for t in first)
        else:
            repeat = torch.equal(first, again)
            if name == "pair_gram":      # upper triangle, mirrored
                repeat = repeat and torch.equal(first, first.T)
            errs = [float((first - want).abs().max())]
            limits = [sum_tol * max(1.0, float(want.abs().max()))
                      if name == "pair_gram" else KERNEL_TOL * scale]
            ok = bool(torch.isfinite(first).all())
        if not (ok and repeat and all(e <= lim for e, lim in zip(errs,
                                                                  limits))):
            raise AssertionError(
                f"{name} {label}: errors {errs} vs limits {limits}, "
                f"finite {ok}, bitwise repeat (and the Gram symmetric) "
                f"{repeat}")
        t = timing(kern)
        plain_ms = cuda_ms(plain, plain_reps(n * d))
        library_ms = (None if lib is None
                      else cuda_ms(lib, plain_reps(n * d)))
        bound_ms, bound_by = bound_of(bytes_moved, ops)
        row = {"kernel": name, "kind": kind, "label": label, "n": n, "d": d,
               "k": k, "base_rows": base_rows, "s": s, "weighted": weighted,
               "m": m, "invalid": list(invalid),
               "max_abs_err": max(errs), "errs": errs, "err_limits": limits,
               "bitwise_repeat": repeat, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "bytes": bytes_moved, "ops": ops,
               **t}
        sq_txt = ""
        # the drivers' call: sq alone, no z (a tree from before it, timed
        # with this script under --phases kernels, has none)
        if name == "rfa_iter" and hasattr(N, "_rfa_sq"):
            sq = N._rfa_sq(x, wr, w, mask, mean, std, valid, attack=alie)
            if not torch.equal(sq, first[1]):
                raise AssertionError(f"rfa_iter {label}: sq alone differs "
                                     "from the public call's sq")
            row["sq_alone"] = {
                **timing(lambda: N._rfa_sq(x, wr, w, mask, mean, std, valid,
                                           attack=alie)),
                "bound_ms": bound_of(bytes_moved - d * 4, ops)[0]}
            sq_txt = (f"; sq alone (the driver's call) "
                      f"{timing_text(row['sq_alone'])}, bound "
                      f"{row['sq_alone']['bound_ms']:.4f} ms")
        rows.append(row)
        lib_txt = ("n/a" if library_ms is None else f"{library_ms:.4f} ms")
        print(f"[kernel] {name:12s} {kind:11s} {label}: n={n} d={d} k={k} "
              f"s={s}{' masked' if invalid else ''}"
              f"{f' weighted m={m}' if weighted else ''} | errs {', '.join(f'{e:.3e}' for e in errs)} (limits "
              f"{', '.join(f'{v:.3e}' for v in limits)}) repeat bitwise | "
              f"kernel {timing_text(t)}; plain {plain_ms:.4f} ms bound "
              f"{bound_ms:.4f} ms ({bound_by}) library {lib_txt}{sq_txt}",
              flush=True)
        del first, again, want
    del x, w, mean, std, sent, xb, spec
    torch.cuda.empty_cache()
    return rows


def blocked_case(case, dev, card):
    """Each blocked kernel on one dense (m, d) stack: against its plain
    version, twice for bit-for-bit repeatability (and the Gram for bitwise
    symmetry), and timed beside its plain version and a library call.
    Returns one row per kernel."""
    from repro_torch.kernels import norm_agg as N
    label, m, d = case
    g = torch.Generator(device=dev).manual_seed(m * 7919 + d)
    x = torch.randn(m, d, device=dev, generator=g)
    z = torch.randn(d, device=dev, generator=g)
    w = torch.rand(m, device=dev, generator=g)
    w = w / w.sum()
    stack_bytes = m * d * 4
    # kernel, plain, library, bytes, operations (Gram: i <= j, in split
    # float32 on the tensor cores: three TF32 products a term, so its bound
    # is at the TF32 rate; the float32 bound of one product is kept beside)
    spec = {
        "pair_gram_blocked": (
            lambda: N.pair_gram_blocked(x),
            lambda: N.pair_gram_blocked_plain(x),
            lambda: torch.matmul(x, x.T),
            stack_bytes + m * m * 4, 3 * m * (m + 1) * d),
        "sqdist_to_blocked": (
            lambda: N.sqdist_to_blocked(x, z),
            lambda: N.sqdist_to_blocked_plain(x, z),
            lambda: torch.cdist(x, z[None]).square(),
            stack_bytes + d * 4 + m * 4, 3 * m * d),
        "weighted_sum_blocked": (
            lambda: N.weighted_sum_blocked(x, w),
            lambda: N.weighted_sum_blocked_plain(x, w),
            lambda: torch.mv(x.T, w),
            stack_bytes + m * 4 + d * 4, 2 * m * d),
    }
    rows = []
    for name, (kern, plain, lib, bytes_moved, ops) in spec.items():
        first, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        repeat = torch.equal(first, again)
        symmetric = (bool(torch.equal(first, first.T))
                     if name == "pair_gram_blocked" else None)
        err = float((first - want).abs().max())
        # the blocked weighted sum takes the plain version's order: equal
        limit = (0.0 if name == "weighted_sum_blocked"
                 else SUM_TOL * max(1.0, float(want.abs().max())))
        ok = bool(torch.isfinite(first).all())
        if name == "weighted_sum_blocked":
            ok = ok and torch.equal(first, want)
        if not (ok and repeat and symmetric is not False and err <= limit):
            raise AssertionError(
                f"{name} {label}: error {err} vs limit {limit}, finite {ok},"
                f" bitwise repeat {repeat}, symmetric {symmetric}")
        t = timing(kern)
        plain_ms = cuda_ms(plain, plain_reps(m * d))
        library_ms = cuda_ms(lib, plain_reps(m * d))
        gram = name == "pair_gram_blocked"
        bound_ms, bound_by = bound_of(
            bytes_moved, ops, TF32_OPS_PER_S if gram else FP32_OPS_PER_S)
        fp32_ms = bound_of(bytes_moved, ops // 3)[0] if gram else None
        rows.append({
            "kernel": name, "label": label, "m": m, "d": d,
            "max_abs_err": err, "err_limit": limit, "bitwise_repeat": repeat,
            "symmetric": symmetric, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "fp32_bound_ms": fp32_ms,
            "library_ms": library_ms, "bytes": bytes_moved, "ops": ops, **t})
        fp32_txt = (f", float32 bound {fp32_ms:.4f} ms" if gram else "")
        print(f"[kernel] {name:20s} {label}: m={m} d={d} | err {err:.3e} "
              f"(limit {limit:.3e}) repeat bitwise"
              f"{', symmetric bitwise' if symmetric else ''} | kernel "
              f"{timing_text(t)}; plain {plain_ms:.4f} ms bound "
              f"{bound_ms:.4f} ms "
              f"({bound_by}{', split TF32' if gram else ''}){fp32_txt} "
              f"library {library_ms:.4f} ms [{card}]",
              flush=True)
        del first, again, want
    del x, z, w, spec
    torch.cuda.empty_cache()
    return rows


def topk_case(case, dev, card):
    """TopK's select kernels on one (rows, d) stack, random and full of
    ties: ``topk_support`` (the ascending indices and x at them) and
    ``topk_select`` against their plain twins exactly, the support twice
    for bit-for-bit repeatability. Timed: ``topk_support`` (its call, and
    the select kernels alone: device ms and device ops per call), the whole
    ``topk_select``, the plain twins and ``torch.topk(x.abs(), k)``; the
    bound is x read once and the k indices written, with the per-tile pool
    design's bound (its pools written too) beside it."""
    from repro_torch.kernels import quantize as Q
    label, rows, d, k = case
    g = torch.Generator(device=dev).manual_seed(rows * 7919 + d)
    x = torch.randn(rows, d, device=dev, generator=g)
    for kind in ("random", "ties"):
        inp = (x if kind == "random" else
               torch.randint(-3, 4, (rows, d), device=dev,
                             generator=g).float())
        first = Q.topk_support(inp, k)
        again = Q.topk_support(inp, k)
        sel = Q.topk_select(inp, k)
        want = Q.topk_support_plain(inp, k)[0]
        want_sel = Q.topk_select_plain(inp, k)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(first, again))
        mismatched = (int((first[0] != want).sum())
                      + int((sel != want_sel).sum()))
        if not (repeat and mismatched == 0 and sel.shape == (rows, k)
                and torch.equal(first[1], torch.gather(inp, 1,
                                                       first[0].long()))):
            raise AssertionError(
                f"topk_select {label} ({kind}): {mismatched} indices differ "
                f"from the plain twins, bitwise repeat {repeat}")
        del inp, first, again, sel, want, want_sel
    t = timing(lambda: Q.topk_support(x, k))
    whole = timing(lambda: Q.topk_select(x, k))
    reps = plain_reps(rows * d)
    plain_ms = cuda_ms(lambda: Q.topk_support_plain(x, k), reps)
    plain_select_ms = cuda_ms(lambda: Q.topk_select_plain(x, k), reps)
    library_ms = cuda_ms(lambda: torch.topk(x.abs(), k, dim=-1), reps)
    bytes_moved = 4 * rows * d + 4 * rows * k
    bound_ms, bound_by = bound_of(bytes_moved, 0)
    cp = min(2048, max(128, -(-min(k, 2048) // 128) * 128))
    pool_bound_ms = bound_of(4 * rows * d + 8 * rows * -(-d // 2048) * cp,
                             0)[0]
    row = {"kernel": "topk_select", "label": label, "rows": rows, "d": d,
           "k": k, "max_abs_err": 0.0, "mismatched": 0,
           "bitwise_repeat": True, "whole_ms": whole["ms"],
           "whole_device_ms": whole["device_ms"],
           "whole_device_ops": whole["device_ops"], "plain_ms": plain_ms,
           "plain_select_ms": plain_select_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "pool_bound_ms": pool_bound_ms,
           "library_ms": library_ms, "bytes": bytes_moved, **t}
    print(f"[kernel] topk_select {label}: rows={rows} d={d} k={k} | support "
          f"and selection equal to the plain twins (random and ties), "
          f"repeat bitwise | topk_support {timing_text(t)}; whole "
          f"topk_select {timing_text(whole)}; plain support {plain_ms:.4f} "
          f"ms, plain select {plain_select_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; the pool design's "
          f"{pool_bound_ms:.4f}), torch.topk {library_ms:.4f} ms [{card}]",
          flush=True)
    del x
    torch.cuda.empty_cache()
    return row


def ops_path(dev, card):
    """The block quantizer's main path, the ``ops.block_quantize`` entry
    point, once per shape with the counts set to 0 just before; then each
    result against the plain version on the dither the entry point drew
    (exact, or the levels that differ are counted and fail the check),
    a bitwise repeat, and the times of kernel, plain version and bound (12
    bytes a coordinate: x and u read, out written)."""
    from repro_torch import random as R
    from repro_torch.kernels import ops, quantize as Q
    inputs = []
    for label, d in QUANT_CASES:
        g = torch.Generator(device=dev).manual_seed(d)
        x = torch.randn(d, device=dev, generator=g) * torch.rand(
            d, device=dev, generator=g)
        inputs.append((label, d, x, R.PRNGKey(d, device=dev)))
    reset_counts()
    outs = [ops.block_quantize(x, key, levels=QUANT_LEVELS)
            for _, _, x, key in inputs]
    torch.cuda.synchronize()
    counts = read_counts()
    want_counts = {**dict.fromkeys(COUNTED, 0),
                   "block_quantize": len(QUANT_CASES)}
    if counts != want_counts:
        raise AssertionError(f"ops path: launches {counts}, expected "
                             f"{want_counts}")
    rows = []
    for (label, d, x, key), got in zip(inputs, outs):
        u = R.uniform(key, x.shape)
        want = Q.block_quantize_plain(x, u, levels=QUANT_LEVELS)
        again = Q.block_quantize(x, u, levels=QUANT_LEVELS)
        torch.cuda.synchronize()
        flips = int((got != want).sum())
        err = float((got - want).abs().max())
        repeat = torch.equal(got, again)
        if not (flips == 0 and repeat and got.shape == (d,)
                and torch.isfinite(got).all()):
            raise AssertionError(
                f"block_quantize {label}: {flips} coordinates differ from "
                f"the plain version (max abs err {err}), bitwise repeat "
                f"{repeat}")
        del want, again
        t = timing(lambda: Q.block_quantize(x, u, levels=QUANT_LEVELS))
        entry_ms = cuda_ms(lambda: ops.block_quantize(x, key,
                                                      levels=QUANT_LEVELS))
        plain_ms = cuda_ms(lambda: Q.block_quantize_plain(
            x, u, levels=QUANT_LEVELS), plain_reps(d))
        bound_ms, bound_by = bound_of(12 * d, 0)
        rows.append({"kernel": "block_quantize", "label": label, "d": d,
                     "levels": QUANT_LEVELS, "max_abs_err": err,
                     "flips": flips, "bitwise_repeat": repeat,
                     "entry_ms": entry_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None, "bytes": 12 * d, **t})
        print(f"[kernel] block_quantize {label}: d={d} levels={QUANT_LEVELS}"
              f" | through ops.block_quantize, {flips} levels differ from "
              f"the plain version, repeat bitwise | kernel {timing_text(t)}; "
              f"ops entry (dither draw + kernel) {entry_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"library n/a [{card}]", flush=True)
        del u
    del inputs, outs
    torch.cuda.empty_cache()
    return {"launches": counts, "cases": rows}


QUANT_KERNELS = ("topk_select", "block_quantize")
FUSED_KERNELS = ("robust_agg",) + NORM_KERNELS
LOADS = ("dense", "dense_bf16", "sparse", "int8", "sign", "bf16")
# a fused kernel's launches per load, unmasked and masked:
# "robust_agg/int8", "pair_gram/bf16 masked", ...
COUNTED = (tuple(f"{name}/{load}{tag}" for name in FUSED_KERNELS
                 for load in LOADS for tag in ("", " masked"))
           + BLOCKED_KERNELS + QUANT_KERNELS)


# a fused kernel's launches per aggregation of one segment or leaf: RFA
# makes T = 8 Weiszfeld passes and a weighted sum, Krum a Gram and a sum
PER_AGG = {"cm": {"robust_agg": 1},
           "rfa": {"rfa_iter": 8, "weighted_sum": 1},
           "krum": {"pair_gram": 1, "weighted_sum": 1}}


def _fused(name):
    from repro_torch.kernels import norm_agg
    from repro_torch.kernels.robust_agg import robust_agg
    return robust_agg if name == "robust_agg" else getattr(norm_agg, name)


def reset_counts():
    from repro_torch.kernels import _launch, norm_agg, quantize
    for name in FUSED_KERNELS:
        _launch.reset_counts(_fused(name))
    for name in BLOCKED_KERNELS:
        getattr(norm_agg, name).launches = 0
    for name in QUANT_KERNELS:
        getattr(quantize, name).launches = 0


def read_counts() -> dict:
    """Every count of COUNTED: a fused kernel's launches on each load
    without a validity mask ("name/load") and with one ("... masked")."""
    from repro_torch.kernels import norm_agg, quantize
    counts = {}
    for name in FUSED_KERNELS:
        fn = _fused(name)
        for load in LOADS:
            masked = fn.masked_load_launches[load]
            counts[f"{name}/{load}"] = fn.load_launches[load] - masked
            counts[f"{name}/{load} masked"] = masked
    counts.update({name: getattr(norm_agg, name).launches
                   for name in BLOCKED_KERNELS})
    counts.update({name: getattr(quantize, name).launches
                   for name in QUANT_KERNELS})
    return counts


def nonzero(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def _add(counts, name, load, n, masked=False):
    key = f"{name}/{load}{' masked' if masked else ''}"
    counts[key] += n


def expected_counts(aggregator, full, vr, giant=False, guard=False,
                    cohort=False, fmt="sparse", dense_vr=False) -> dict:
    """Launches of one MARINA run: one init aggregation and F full rounds
    on the packed b+w segment (dense load), V VR rounds on the two leaves'
    wire payloads of ``fmt``; RFA makes T = 8 Weiszfeld passes and a
    weighted sum per segment, Krum a Gram and a weighted sum. At 256
    workers every aggregation (dense or wire) takes the giant-n tier on
    the two leaves b and w, unpacked: RFA 2·(8 + 1) blocked weighted sums
    and 2·8 blocked distances, Krum 2 blocked Grams and 2 blocked weighted
    sums, and no fused kernel (with or without a sampled cohort: the
    masked bucket operator keeps m = 128 rows). The fault guard adds no
    launch and masks every one (the init's too). Under a sampled cohort
    (``cohort``, cm at 5 workers) the init is unmasked, and every round,
    VR rounds reconstructed densely, is one masked launch on the packed
    segment. An attack
    the load cannot apply (RN, ``dense_vr``) takes every VR round off the
    wire: its candidates are rebuilt and aggregated as the packed dense
    segment, one more dense aggregation a round, and no wire launch."""
    counts = dict.fromkeys(COUNTED, 0)
    if cohort:
        _add(counts, "robust_agg", "dense", 1)
        _add(counts, "robust_agg", "dense", full + vr, masked=True)
        return counts
    if giant:
        aggs = 1 + full + vr
        if aggregator == "rfa":
            counts["weighted_sum_blocked"] = 2 * (8 + 1) * aggs
            counts["sqdist_to_blocked"] = 2 * 8 * aggs
        else:
            counts["pair_gram_blocked"] = 2 * aggs
            counts["weighted_sum_blocked"] = 2 * aggs
        return counts
    if dense_vr:
        full, vr = full + vr, 0
    for name, times in PER_AGG[aggregator].items():
        _add(counts, name, "dense", times * (1 + full), guard)
        _add(counts, name, fmt, times * 2 * vr, guard)
    return counts


def zoo_counts(aggregator, rounds, fmt="dense", guard=False) -> dict:
    """Launches of a run of the method zoo: no aggregation at init, one
    a round, on the packed b+w segment (``fmt`` "dense") or on each of
    the two leaves' wire payloads; every one masked under the fault
    guard."""
    counts = dict.fromkeys(COUNTED, 0)
    leaves = 1 if fmt == "dense" else 2
    for name, times in PER_AGG[aggregator].items():
        _add(counts, name, fmt, times * leaves * rounds, guard)
    return counts


def ef21_counts(rounds, fmt="sparse", aggregator="cm",
                guard=False) -> dict:
    """Launches of a Byz-EF21 run: the dense init and every round on the
    wire of ``fmt`` each aggregate the leaves b and w apart (w, 5000 wide,
    is not packed with b: only leaves under 1024 share a launch), with cm
    (robust_agg) or Krum (a Gram and a weighted sum per leaf), every one
    masked under the fault guard; on the sparse (TopK) wire every round
    selects TopK on w (b, one wide, takes the plain sort)."""
    counts = dict.fromkeys(COUNTED, 0)
    names = (("robust_agg",) if aggregator == "cm"
             else ("pair_gram", "weighted_sum"))
    for name in names:
        _add(counts, name, "dense", 2, guard)
        _add(counts, name, fmt, 2 * rounds, guard)
    if fmt == "sparse":
        counts["topk_select"] = rounds
    return counts


def main_path(dev, card, tag, spec, want_counts, diverges=False,
              traj_tol=TRAJ_TOL):
    """One path through ``api.run`` on the card, the counts set to 0 just
    before; its launches against ``want_counts(full, vr, rounds)``, its
    losses finite and falling, and its first rounds against the CPU
    path, to ``traj_tol``. A path that ``diverges`` (as the reference
    diverges on it) starts finite and must agree with the CPU path round
    for round, NaN for NaN, to ``traj_tol`` relative to max(1, |loss|)."""
    from repro_torch.api import RunSpec, run
    reset_counts()
    t0 = time.time()
    res = run(RunSpec(**spec), device=dev, log_every=1)
    wall = time.time() - t0
    counts = read_counts()
    hist = res.history
    coin = "c_k" in hist[0]              # MARINA's; other methods have none
    losses = [h["loss"] for h in hist]
    ck = [int(h.get("c_k", 1)) for h in hist]
    full = sum(ck)
    vr = len(ck) - full
    for h in hist[::50] + [hist[-1]]:
        print(f"[main {tag}] step {h['step']:4d} loss {h['loss']:.6f}"
              + (f" c_k={int(h['c_k'])}" if coin else ""), flush=True)
    per_round_ms = res.wall_s / len(hist) * 1e3
    rounds = (f"{full} full (c_k=1), {vr} VR" if coin
              else "every round uploads")
    print(f"[main {tag}] {len(hist)} rounds, {rounds}; "
          f"{per_round_ms:.3f} ms per round (host clock, loop "
          f"only); run() wall {wall:.2f} s incl. data and init; launches "
          f"{nonzero(counts)} [{card}]", flush=True)
    finite = [math.isfinite(v) for v in losses]
    if diverges:
        if not finite[0]:
            raise AssertionError(f"{tag}: the first loss is not finite")
        print(f"[main {tag}] diverges as the reference does: first "
              f"non-finite loss at round "
              f"{finite.index(False) if False in finite else None}",
              flush=True)
    elif not all(finite):
        raise AssertionError(f"non-finite loss on the {tag} path")
    elif not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: final loss {losses[-1]} not "
                             f"below the first {losses[0]}")
    want = want_counts(full, vr, len(hist))
    if counts != want:
        raise AssertionError(
            f"{tag}: launches {nonzero(counts)}, expected {nonzero(want)}: "
            "an aggregation bypassed its kernel")
    cpu_hist = CPU_RUNS.history({**spec, "steps": CPU_CHECK_STEPS})
    cpu_ck = [int(h.get("c_k", 1)) for h in cpu_hist]
    if cpu_ck != ck[:CPU_CHECK_STEPS]:
        raise AssertionError(f"{tag}: c_k differs from the CPU path: "
                             f"{cpu_ck} vs {ck[:CPU_CHECK_STEPS]}")
    if coin and 1 not in cpu_ck:
        raise AssertionError(f"{tag}: no full round (c_k=1) among the "
                             f"{CPU_CHECK_STEPS} rounds held to the CPU path")
    got = np.array(losses[:CPU_CHECK_STEPS])
    ref = np.array([h["loss"] for h in cpu_hist])
    if diverges:
        fin = np.isfinite(ref)
        same = np.array_equal(np.isnan(got), np.isnan(ref))
        diff = float(np.max(np.abs(got[fin] - ref[fin])
                            / np.maximum(1.0, np.abs(ref[fin]))))
        what = "max |loss diff| / max(1, |loss|), NaN for NaN"
    else:
        same = True
        diff = float(np.max(np.abs(got - ref)))
        what = "max |loss diff|"
    print(f"[main {tag}] first {CPU_CHECK_STEPS} rounds vs the CPU "
          f"plain path: c_k identical, {what} {diff:.3e} (limit "
          f"{traj_tol})", flush=True)
    if not (same and diff <= traj_tol):
        raise AssertionError(f"{tag}: loss differs from the CPU path "
                             f"by {diff} (NaN rounds alike: {same})")
    return {"method": spec["method"], "aggregator": spec["aggregator"],
            "compressor": spec["compressor"],
            "n_workers": spec["n_workers"], "dim": spec["data_kwargs"]["dim"],
            "launches": counts,
            "rounds": len(hist), "full_rounds": full,
            "per_round_ms": per_round_ms, "run_wall_s": wall,
            "final_loss": losses[-1], "first_loss": losses[0],
            "cpu_loss_diff": diff, "diverges": diverges}


PROFILE_STEPS = 5                  # rounds of each profiled path
PROFILED_PATHS = ("cm", "rfa", "krum", "cm chaos", "byz_ef21 topk")


def path_profile(dev, card, tag, spec):
    """Where a path's round goes: PROFILE_STEPS rounds through ``api.run``
    under torch.profiler's CUDA activity (the tracer's cost on the host
    included in the wall time), after a warm-up run. Returns the host
    clock's ms a round, the device's busy ms a round (the summed duration
    of every kernel, copy and fill), the device operations a round, and
    the device time by operation name, largest first."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import RunSpec, run
    spec = {**spec, "steps": PROFILE_STEPS}
    run(RunSpec(**{**spec, "steps": 3}), device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        res = run(RunSpec(**spec), device=dev, log_every=1)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    evts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in evts:
        by_name[e.name[:50]] = (by_name.get(e.name[:50], 0.0)
                                + e.time_range.elapsed_us() / 1e3)
    steps = len(res.history)
    wall_ms = res.wall_s / steps * 1e3
    busy_ms = sum(by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {"path": tag, "rounds": steps, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "device_ops": len(evts) / steps,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "top_ms_per_round": {k: v / steps for k, v in top}}
    print(f"[profile {tag}] {steps} rounds: {wall_ms:.3f} ms a round "
          f"(host clock), device busy {busy_ms:.4f} ms a round in "
          f"{len(evts) / steps:.1f} device ops; idle share "
          f"{row['idle_share']:.3f}; top: "
          + ", ".join(f"{k} {v / steps:.4f}" for k, v in top[:4])
          + f" [{card}]", flush=True)
    return row


def ops_wire_path(dev, card):
    """The ``kernels.ops`` entry points on the dense wires and on a
    bfloat16 stack at gisette width (5 workers, bucketing s = 2), the
    counts set to 0 just before: ``wire_agg`` with cm, RFA and Krum on an
    int8 payload with a shared base and on sign and bf16 payloads with
    per-worker bases, and ``robust_agg``, ``rfa_agg`` and ``krum_agg`` on
    the bf16 stack. Each result against the same call on CPU copies of
    the inputs (the plain versions): KERNEL_TOL of the largest input for
    cm (W·x in another order), 2e-5 for RFA and Krum."""
    from repro_torch import random as R
    from repro_torch.kernels import ops, quantize
    n, d = 5, 5000
    g = torch.Generator(device=dev).manual_seed(d)
    key = R.PRNGKey(7, device=dev)
    inputs = []
    for fmt, base_rows in OPS_WIRES:
        rows = torch.randn(n, d, device=dev, generator=g)
        keys = R.fold_in(R.PRNGKey(d, device=dev),
                         torch.arange(n, device=dev))
        pay = quantize.PACK[fmt](keys, rows)
        inputs.append((fmt, quantize.WireSrc(
            fmt=fmt, n=n, d=d, arrays=tuple(pay.items()),
            base=torch.randn(base_rows, d, device=dev, generator=g))))
    stack = torch.randn(n, d, device=dev, generator=g).bfloat16()

    def calls(on):
        out = {}
        for fmt, src in inputs:
            src = on(src)
            for rule in OPS_RULES:
                out[f"wire_agg {fmt} {rule}"] = ops.wire_agg(
                    src, on(key), bucket_size=2, rule=rule)
        x = on(stack)
        out["robust_agg bf16 stack"] = ops.robust_agg(x, on(key),
                                                      bucket_size=2)
        out["rfa_agg bf16 stack"] = ops.rfa_agg(x, on(key), bucket_size=2)
        out["krum_agg bf16 stack"] = ops.krum_agg(x, on(key), bucket_size=2)
        return out

    reset_counts()
    got = calls(lambda t: t)
    torch.cuda.synchronize()
    counts = read_counts()
    want_counts = dict.fromkeys(COUNTED, 0)
    for load in ("int8", "sign", "bf16", "dense_bf16"):
        for name, times in (("robust_agg", 1), ("rfa_iter", 8),
                            ("weighted_sum", 2), ("pair_gram", 1)):
            _add(want_counts, name, load, times)
    if counts != want_counts:
        raise AssertionError(f"ops wire path: launches {nonzero(counts)}, "
                             f"expected {nonzero(want_counts)}")

    def to_cpu(t):
        if isinstance(t, quantize.WireSrc):
            return quantize.WireSrc(
                fmt=t.fmt, n=t.n, d=t.d,
                arrays=tuple((k, a.cpu()) for k, a in t.arrays),
                base=t.base.cpu(), cand_dtype=t.cand_dtype)
        return t.cpu()

    want = calls(to_cpu)
    scale = max(1.0, float(stack.float().abs().max()),
                 *(float(quantize.recon(src).abs().max())
                   for _, src in inputs))
    errs = {}
    for name, out in got.items():
        err = float((out.cpu() - want[name]).abs().max())
        limit = (KERNEL_TOL if "median" in name or "robust" in name
                 else TRAJ_TOL) * scale
        errs[name] = err
        if not (out.shape == (d,) and torch.isfinite(out).all()
                and err <= limit):
            raise AssertionError(f"ops {name}: max abs err {err} > {limit}")
    print(f"[ops wire] kernels.ops on the int8, sign and bf16 wires and a "
          f"bf16 stack (n={n}, d={d}): launches {nonzero(counts)}; against "
          f"the plain versions, max abs err {max(errs.values()):.3e} "
          f"[{card}]", flush=True)
    return {"launches": counts, "max_abs_err": errs}


# the sparse range search of the looping kernels, alone: (label, n, d, k,
# blocks), the column groups of the sparse register load (TILE * 4)
BOUNDS_GROUP = 512
BOUNDS_CASES = [("main path: wire, leaf w", 5, 123, 12, 1),
                ("Byz-EF21 wire, leaf w", 5, 5000, 500, 3),
                ("qwen3-1.7b q_proj layer, RandK 0.1", 8, 4_194_304, 419_430,
                 264)]


def bounds_case(case, dev):
    """``quantize.sparse_bounds`` (the warp search of the looping kernels)
    on ascending RandK rows against its plain twin, and both against
    ``torch.searchsorted``: exact."""
    from repro_torch import random as R
    from repro_torch.kernels import quantize as Q
    label, n, d, k, blocks = case
    keys = R.fold_in(R.PRNGKey(d, device=dev), torch.arange(n, device=dev))
    idx = torch.sort(R.permutation(keys, d)[:, :k], dim=1).values.int()
    got = Q.sparse_bounds(idx, d, BOUNDS_GROUP, blocks).cpu()
    want = Q.sparse_bounds_plain(idx.cpu(), d, BOUNDS_GROUP, blocks)
    groups = -(-d // BOUNDS_GROUP)
    lo = torch.tensor([groups * b // blocks * BOUNDS_GROUP
                       for b in range(blocks)], dtype=torch.int32)
    ref = torch.searchsorted(idx.cpu(), lo.expand(n, blocks).contiguous(),
                             out_int32=True).T
    if not (torch.equal(got, want) and torch.equal(want, ref)):
        raise AssertionError(f"sparse range search {label}: kernel, plain "
                             "twin and searchsorted differ")
    print(f"[kernel] sparse range search {label}: n={n} d={d} k={k} "
          f"blocks={blocks} | kernel = plain twin = searchsorted", flush=True)
    return {"label": label, "n": n, "d": d, "k": k, "blocks": blocks,
            "equal": True}


LEAN_KERNELS = ("robust_agg", "weighted_sum", "pair_gram", "rfa_iter",
                "weighted_sum_blocked", "pair_gram_blocked",
                "sqdist_to_blocked")


def check_lean(cases):
    """A steady-state call of a kernel of LEAN_KERNELS (``rfa_iter``'s
    public call and its sq-alone call) issues exactly one device
    operation, its kernel, on every load and shape (no row pointers, no
    mask conversion, no second launch, no copy or fill), where the
    profiler recorded the calls: every operation it saw is the kernel,
    one a call (the tracer loses or repeats an event in some windows of
    REPS calls, so the count is rounded)."""
    timed = [(r["kernel"], r.get("kind"), r["label"], t)
             for rows in cases.values() for r in rows
             if r.get("kernel") in LEAN_KERNELS
             for t in (r, r.get("sq_alone")) if t is not None]
    bad = [(name, kind, label, t["device_ops"], t["device_op_names"])
           for name, kind, label, t in timed
           if t["device_ops"] is not None
           and (round(t["device_ops"]) != 1
                or any(name not in op for op in t["device_op_names"]))]
    if bad:
        raise AssertionError(f"calls with more than one device op: {bad}")


def kernel_entry(name, source, replaces, launches, rows):
    """One entry of the kernels line, from the main-path cases' rows."""
    if launches < 1:
        raise AssertionError(f"{name} never ran on its main path")
    libs = [r["library_ms"] for r in rows]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": statistics.mean(r["ms"] for r in rows),
        "plain_ms": statistics.mean(r["plain_ms"] for r in rows),
        "bound_ms": statistics.mean(r["bound_ms"] for r in rows),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                     else "operations"),
        "library_ms": None if None in libs else statistics.mean(libs),
        "device_ms": (None if any(r["device_ms"] is None for r in rows)
                      else statistics.mean(r["device_ms"] for r in rows)),
        "device_ops": max((r["device_ops"] or 0) for r in rows)}


TRACED_STEPS = 10                # rounds of each traced twin
# the traced twins: (tag, spec, the untraced path's launches)
TRACED_PATHS = [
    ("cm", MAIN_SPEC, lambda f, v, r: expected_counts("cm", f, v)),
    ("rfa", {**MAIN_SPEC, "aggregator": "rfa"},
     lambda f, v, r: expected_counts("rfa", f, v)),
    ("krum", {**MAIN_SPEC, "aggregator": "krum"},
     lambda f, v, r: expected_counts("krum", f, v)),
    ("rfa n=256", {**MAIN_SPEC, **GIANT_SPEC, "aggregator": "rfa"},
     lambda f, v, r: expected_counts("rfa", f, v, giant=True)),
    ("krum n=256", {**MAIN_SPEC, **GIANT_SPEC, "aggregator": "krum"},
     lambda f, v, r: expected_counts("krum", f, v, giant=True)),
    ("cm chaos", {**MAIN_SPEC, **CHAOS_SPEC},
     lambda f, v, r: expected_counts("cm", f, v, guard=True)),
    ("cm participation 0.8", {**MAIN_SPEC, **PART_SPEC},
     lambda f, v, r: expected_counts("cm", f, v, cohort=True)),
]
TRACE_EXACT = ("byz_mask", "fault_mask", "guard_valid", "sampled_mask",
               "krum_selected")
# cm's and tm's selection fractions count rank positions; where rows tie
# exactly (on a RandK round every row carries g^k off the support) an ulp
# of g^k, which the card's and the CPU's trajectories do not share (their
# gradients part by ~1e-7, ROADMAP queue 3), moves the padded bucket to
# either side of the tie. They are held on identical inputs instead
TRACE_RANKED = ("bucket_weights", "influence")


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def trace_errors(got, ref, g_norm, ranked=True) -> dict:
    """Each field's largest difference over its scale: the field's largest
    entry, and for the distances (rounding noise on a full round, whose
    rows all carry the anchor gradient) the aggregate's norm at least
    (its square for Krum's scores). The exact fields must be equal, and
    infinities (the guard's Krum scores) must sit alike."""
    if sorted(got) != sorted(ref) or got["rule"] != ref["rule"]:
        raise AssertionError(f"trace fields {sorted(got)} vs {sorted(ref)}")
    errs = {}
    for k in ref:
        if k == "rule" or (not ranked and ref["rule"] in ("cm", "tm")
                           and k in TRACE_RANKED):
            continue
        if k in TRACE_EXACT:
            if got[k] != ref[k]:
                raise AssertionError(f"trace {k}: {got[k]} vs {ref[k]}")
            continue
        a = np.atleast_1d(np.asarray(got[k], np.float64))
        b = np.atleast_1d(np.asarray(ref[k], np.float64))
        fin = np.isfinite(b)
        if not (np.array_equal(np.isfinite(a), fin)
                and np.array_equal(a[~fin], b[~fin])):
            raise AssertionError(f"trace {k}: {a} vs {b}")
        top = float(np.max(np.abs(b[fin]), initial=0.0))
        scale = (max(top, g_norm) if k in ("dist_to_agg", "rfa_residual")
                 else max(top, g_norm ** 2) if k == "krum_scores" else top)
        err = float(np.max(np.abs(a[fin] - b[fin]), initial=0.0))
        errs[k] = err / scale if scale > 0 else err
    return errs


def _merge_max(acc, errs):
    for k, v in errs.items():
        acc[k] = max(acc.get(k, 0.0), v)


def _same_run(a, b) -> bool:
    return ([h["loss"] for h in a.history] == [h["loss"] for h in b.history]
            and all(torch.equal(a.state[k][n], b.state[k][n])
                    for k in ("params", "g") for n in a.state[k]))


def traced_path(dev, card, tag, spec, want_counts):
    """A path's telemetry twin on the card: TRACED_STEPS rounds untraced
    twice, then traced, each with the counts set to 0 just before.
    (a) every run's launches equal the path's formula, the traced run's
    included; (b) the two untraced runs repeat bit for bit, and the
    traced run ends with their losses and parameters bit for bit; (c) the
    first CPU_CHECK_STEPS traces agree with the CPU path's traced run
    (``trace_errors``, TRAJ_TOL, cm's rank fields aside), and each of
    those rounds' trace, rebuilt on the CPU from the card's own inputs to
    ``obs.trace._build_trace``, agrees with the card's in every field."""
    from repro_torch.api import RunSpec, run
    from repro_torch.obs import trace as T
    spec = {**spec, "steps": TRACED_STEPS}
    orig = T._build_trace
    captured = []

    def capture(cfg, agg_key, sent, agg, **kw):
        rt = orig(cfg, agg_key, sent, agg, **kw)
        if len(captured) < CPU_CHECK_STEPS:
            captured.append((cfg, _to_cpu(agg_key), _to_cpu(sent),
                             _to_cpu(agg), _to_cpu(kw), rt))
        return rt

    runs = []
    for traced in (False, False, True):
        reset_counts()
        T._build_trace = capture if traced else orig
        try:
            res = run(RunSpec(**spec, trace=traced), device=dev, log_every=1)
        finally:
            T._build_trace = orig
        runs.append((res, read_counts()))
    (u1, c1), (u2, c2), (tr, ct) = runs
    ck = [int(h.get("c_k", 1)) for h in u1.history]
    want = want_counts(sum(ck), len(ck) - sum(ck), len(ck))
    for what, counts in (("untraced", c1), ("untraced again", c2),
                         ("traced", ct)):
        if counts != want:
            raise AssertionError(f"traced {tag}: {what} launches "
                                 f"{nonzero(counts)}, expected "
                                 f"{nonzero(want)}")
    repeats, same = _same_run(u1, u2), _same_run(u1, tr)
    if not repeats:
        raise AssertionError(f"traced {tag}: two untraced runs differ")
    if not same:
        raise AssertionError(f"traced {tag}: the traced run's losses or "
                             "parameters differ from the untraced run's")
    cpu = run(RunSpec(**{**spec, "steps": CPU_CHECK_STEPS}, trace=True),
              device="cpu", log_every=1)
    if [int(h.get("c_k", 1)) for h in cpu.history] != ck[:CPU_CHECK_STEPS]:
        raise AssertionError(f"traced {tag}: c_k differs from the CPU path")
    if "c_k" in cpu.history[0] and 1 not in ck[:CPU_CHECK_STEPS]:
        raise AssertionError(f"traced {tag}: no full round (c_k=1) among "
                             f"the {CPU_CHECK_STEPS} traces held to the CPU "
                             "path")
    vs_cpu, rebuilt = {}, {}
    for a, b, h in zip(tr.traces, cpu.traces, cpu.history):
        _merge_max(vs_cpu, trace_errors(a, b, h["g_norm"], ranked=False))
    for cfg, key, sent, agg, kw, rt in captured:
        g_norm = float(torch.sqrt(sum((v.float() ** 2).sum()
                                      for v in agg.values())))
        _merge_max(rebuilt, trace_errors(
            T.to_host(rt), T.to_host(orig(cfg, key, sent, agg, **kw)),
            g_norm))
    ms = [r.wall_s / len(r.history) * 1e3 for r, _ in runs]
    print(f"[traced {tag}] {TRACED_STEPS} rounds: {ms[0]:.3f} / "
          f"{ms[1]:.3f} ms per round untraced, {ms[2]:.3f} traced (host "
          f"clock, every round traced); launches {nonzero(ct)} in each run; "
          f"untraced runs repeat bit for bit: {repeats}; traced = untraced "
          f"bit for bit: {same}; first {CPU_CHECK_STEPS} traces vs the CPU "
          f"path, max error / scale "
          + json.dumps({k: float(f"{v:.3e}") for k, v in vs_cpu.items()})
          + f"; rebuilt on the CPU from the card's inputs ({len(captured)} "
          "rounds) "
          + json.dumps({k: float(f"{v:.3e}") for k, v in rebuilt.items()})
          + f" [{card}]", flush=True)
    worst = max(list(vs_cpu.values()) + list(rebuilt.values()))
    if len(captured) != CPU_CHECK_STEPS or worst > TRAJ_TOL:
        raise AssertionError(f"traced {tag}: trace fields differ by {worst}"
                             f" of their scale (limit {TRAJ_TOL})")
    return {"tag": tag, "launches": ct, "rounds": TRACED_STEPS,
            "untraced_ms": ms[:2], "traced_ms": ms[2],
            "untraced_repeat": repeats, "traced_equal": same,
            "vs_cpu_err": vs_cpu, "rebuilt_err": rebuilt}


def profile_phase(dev, card):
    """Three rounds of the traced cm path under ``obs.profile
    .profile_trace`` with the step markers on: the Chrome trace must
    hold three ``round`` ranges and the ``robust_agg`` kernel."""
    import shutil
    from repro_torch.api import RunSpec, run
    from repro_torch.obs import profile as P
    out = ROOT / "build" / "chip_smoke_profile"
    shutil.rmtree(out, ignore_errors=True)
    run(RunSpec(**{**MAIN_SPEC, "steps": 2, "trace": True}), device=dev)
    P.enable_step_markers()
    try:
        with P.profile_trace(str(out)):
            time.sleep(PROFILE_PAD_S)
            run(RunSpec(**{**MAIN_SPEC, "steps": 3, "trace": True}),
                device=dev, log_every=1)
            time.sleep(PROFILE_PAD_S)
    finally:
        P.enable_step_markers(False)
    files = sorted(out.glob("trace_*.json"))
    events = json.loads(files[-1].read_text())["traceEvents"]
    rounds = [e for e in events if e.get("name") == P.ROUND_RANGE
              and e.get("cat") == "user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    agg = [e for e in kernels if "robust_agg" in e.get("name", "")]
    print(f"[profile_trace] {files[-1].name}: {len(events)} events, "
          f"{len(rounds)} 'round' ranges, {len(kernels)} kernel events, "
          f"{len(agg)} of robust_agg [{card}]", flush=True)
    if len(rounds) != 3 or not agg:
        raise AssertionError("profile_trace: expected 3 round ranges and a "
                             f"robust_agg kernel, got {len(rounds)} and "
                             f"{len(agg)}")
    return {"file": files[-1].name, "events": len(events),
            "round_ranges": len(rounds), "kernel_events": len(kernels),
            "robust_agg_events": len(agg)}


def zoo_obs_paths(dev, card) -> dict:
    """Sparse-support MARINA, MARINA with the dense compressors and with
    importance sampling, the traced twins and the profiled run."""
    paths = {}
    # the reference aggregates this mode with the rule's plain tree, on
    # the support alone for VR rounds and densely otherwise: no kernel
    # runs, so the path must launch none
    specs = zoo_rest_specs()
    paths["marina sparse_support cm"] = main_path(
        dev, card, "marina sparse_support cm", specs[0],
        lambda f, v, r: dict.fromkeys(COUNTED, 0))
    for (tag, _), spec in zip(ZOO_REST_PATHS, specs[1:]):
        dense = spec["compressor"] != "randk"   # no wire: dense VR rounds
        paths[tag] = main_path(
            dev, card, tag, spec,
            lambda f, v, r, dv=dense: expected_counts("cm", f, v,
                                                      dense_vr=dv))
    traced = {tag: traced_path(dev, card, tag, spec, want)
              for tag, spec, want in TRACED_PATHS}
    return {"paths": paths, "traced": traced,
            "profile_trace": profile_phase(dev, card)}


# the exec phase: checkpoint and resume, the warm-up step, a faulted sweep
# through the worker pool, and a gspmd seed group, all on the card
EXEC_STEPS = 40                  # the uninterrupted run; its rounds 20-39
RESUME_AT = 20                   # hold one c_k = 1 round (29) and VR rounds
SWEEP_STEPS = 20                 # rounds of each sweep and group cell
HANG_TIMEOUT_S = 15.0            # reaps the injected hang
CK_REPS = 5                      # timed checkpoint saves and loads
EXEC_FAULTS = {"seed": 0, "faults": [{"kind": "crash", "workers": [0]},
                                     {"kind": "hang", "workers": [1]}]}


def _history(hist) -> list:
    return [{k: v for k, v in h.items() if k != "wall_s"} for h in hist]


def _states_equal(a, b) -> bool:
    """Two engine states (or trees of them) equal bit for bit, wherever
    their tensors lie."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_states_equal(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape
                and torch.equal(a.cpu().reshape(-1).view(torch.uint8),
                                b.cpu().reshape(-1).view(torch.uint8)))
    return a == b


def _ms_per_round(res) -> float:
    return res.wall_s / max(len(res.history), 1) * 1e3


def _counted(tag, res, counts, want, card):
    if counts != want:
        raise AssertionError(f"exec {tag}: launches {nonzero(counts)}, "
                             f"expected {nonzero(want)}")
    print(f"[exec {tag}] {len(res.history)} rounds, {_ms_per_round(res):.3f}"
          f" ms per round (host clock, loop only); launches "
          f"{nonzero(counts)} [{card}]", flush=True)
    return {"launches": counts, "rounds": len(res.history),
            "per_round_ms": _ms_per_round(res)}


def _rounds(hist):
    ck = [int(h.get("c_k", 1)) for h in hist]
    return sum(ck), len(ck) - sum(ck)


def exec_resume(dev, card, out) -> dict:
    """(1) cm for EXEC_STEPS rounds with a checkpoint every RESUME_AT,
    then a run resumed from the step-RESUME_AT checkpoint: equal to
    rounds RESUME_AT.. of the uninterrupted run bit for bit (every history
    field but wall_s, the segment's comm_bits, the final state), with the
    segment's launches; the checkpoint loads on the CPU equal to the
    card's state at that step; save and load ms. (2) The same run with
    ``warmup=True``: equal bit for bit, its extra launches those of one
    round."""
    import shutil
    from repro_torch.api import RunSpec, run
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    spec = RunSpec(**{**MAIN_SPEC, "steps": EXEC_STEPS})
    ck, at = str(out / "ck"), str(out / f"at{RESUME_AT}")
    held = {}

    def keep(it, state, m):
        if it == RESUME_AT - 1:          # the state the next save holds
            held["state"] = _to_cpu(state)
        elif it == RESUME_AT:            # copy it before the end's save
            for ext in (".npz", ".json"):
                shutil.copy(ck + ext, at + ext)

    paths = {}
    reset_counts()
    full = run(spec, device=dev, log_every=1, checkpoint=ck,
               checkpoint_every=RESUME_AT, callback=keep)
    paths["exec uninterrupted cm"] = _counted(
        "uninterrupted cm", full, read_counts(),
        expected_counts("cm", *_rounds(full.history)), card)
    seg_full, seg_vr = _rounds(full.history[RESUME_AT:])
    if not (seg_full and seg_vr):
        raise AssertionError(f"exec resume: rounds {RESUME_AT}.. hold "
                             f"{seg_full} c_k = 1 and {seg_vr} VR rounds; "
                             "both kinds are needed")
    reset_counts()
    resumed = run(spec, device=dev, log_every=1, resume=at)
    paths["exec resumed cm"] = _counted(
        "resumed cm", resumed, read_counts(),
        expected_counts("cm", seg_full, seg_vr), card)
    base = full.history[RESUME_AT - 1]["comm_bits"]
    want = _history(full.history[RESUME_AT:])
    for h in want:
        h["comm_bits"] -= base
        h["comm_gbits"] = round(h["comm_bits"] / 1e9, 4)
    same = (_history(resumed.history) == want
            and resumed.comm_bits == full.comm_bits - base
            and _states_equal(resumed.state, full.state))
    loaded, step = load_checkpoint(at, like=held["state"], device="cpu")
    on_cpu = step == RESUME_AT and _states_equal(loaded, held["state"])
    print(f"[exec resume] resumed at step {RESUME_AT} ({seg_full} c_k = 1 "
          f"and {seg_vr} VR rounds after it): equal to the uninterrupted "
          f"run bit for bit: {same}; its checkpoint loads on the CPU equal "
          f"to the card's state bit for bit: {on_cpu} [{card}]", flush=True)
    if not (same and on_cpu):
        raise AssertionError("exec resume: the resumed run or its "
                             "checkpoint differs")
    save_ms, load_ms = [], []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(CK_REPS):
        sync()
        t0 = time.perf_counter()
        save_checkpoint(str(out / "timed"), full.state,
                        step=full.state["step"])
        save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        back, _ = load_checkpoint(str(out / "timed"), like=full.state)
        sync()
        load_ms.append((time.perf_counter() - t0) * 1e3)
    if not _states_equal(back, full.state):
        raise AssertionError("exec: a checkpoint round trip differs")
    n_bytes = sum(t.numel() * t.element_size() for k in ("params", "g")
                  for t in full.state[k].values())
    ck_ms = {"save_ms": statistics.median(save_ms),
             "load_ms": statistics.median(load_ms), "state_bytes": n_bytes}
    print(f"[exec checkpoint] the main path's state ({n_bytes} bytes of "
          f"params and g, and the step): save {ck_ms['save_ms']:.3f} ms, "
          f"load {ck_ms['load_ms']:.3f} ms (median of {CK_REPS}; host "
          f"clock, the card synchronized; warm file cache) [{card}]",
          flush=True)
    # the warm-up step takes round 0's key: one more round of its kind
    reset_counts()
    warm = run(spec, device=dev, log_every=1, warmup=True)
    warm_counts = read_counts()
    c0 = int(full.history[0]["c_k"])
    extra = {k: warm_counts[k] - paths["exec uninterrupted cm"]["launches"][k]
             for k in COUNTED}
    want_extra = dict.fromkeys(COUNTED, 0)
    want_extra["robust_agg/dense" if c0 else "robust_agg/sparse"] = \
        1 if c0 else 2
    warm_same = (_history(warm.history) == _history(full.history)
                 and _states_equal(warm.state, full.state))
    print(f"[exec warmup cm] {_ms_per_round(warm):.3f} ms per round (loop "
          f"only, after the throwaway step) against {_ms_per_round(full):.3f}"
          f" without it; equal to that run bit for bit: {warm_same}; "
          f"launches {nonzero(warm_counts)}, of which the throwaway step "
          f"{nonzero(extra)} [{card}]", flush=True)
    if not warm_same or extra != want_extra:
        raise AssertionError(f"exec warmup: equal {warm_same}, throwaway "
                             f"launches {nonzero(extra)} against "
                             f"{nonzero(want_extra)}")
    paths["exec warmup cm"] = {"launches": warm_counts,
                               "rounds": len(warm.history),
                               "per_round_ms": _ms_per_round(warm)}
    return {"paths": paths, "checkpoint": ck_ms, "resume_equal": same,
            "checkpoint_on_cpu_equal": on_cpu, "warmup_equal": warm_same,
            "warmup_extra_launches": nonzero(extra)}


def exec_sweep(dev, card, out) -> dict:
    """(3) cm, rfa, krum x seeds 0, 1 through ``run_sweep`` and a pool of
    two workers pinned to card 0, the first attempt of cell 0 crashing and
    that of cell 1 hanging: every cell done, two retried; each artifact
    equal to an in-process run of its spec on the card (launches
    counted) except wall_s; then one artifact deleted and the sweep
    resumed: that cell alone re-runs and the summary keeps its bytes.
    (4) A gspmd seed group of three through ``run_group``: equal to the
    same cells run serially, bit for bit."""
    from repro_torch import exec as xc
    from repro_torch.api import RunSpec, Sweep, run, run_sweep
    from repro_torch.faults import as_plan
    sweep = Sweep(RunSpec(**{**MAIN_SPEC, "steps": SWEEP_STEPS}),
                  {"aggregator": ("cm", "rfa", "krum"), "seed": (0, 1)})
    pool = xc.WorkerPool(max_workers=2, gpu_ids=("0", "0"),
                         fault_plan=as_plan(EXEC_FAULTS),
                         hang_timeout_s=HANG_TIMEOUT_S)
    summary = out / "sweep_summary.json"
    t0 = time.time()
    srun = run_sweep(sweep, out_dir=str(out), pool=pool,
                     summary_out=str(summary), log_every=1,
                     device=dev.type)
    sweep_s = time.time() - t0
    if srun.failures:
        raise AssertionError(f"exec sweep: failed cells {srun.failures}")
    stats = srun.stats
    if stats["subprocess_cells"] != len(sweep) or \
            stats.get("retried_cells") != 2:
        raise AssertionError(f"exec sweep: {stats}")
    done = {r["run_id"]: r for r in
            xc.Ledger(str(out / "ledger.jsonl")).iter_records()
            if r["status"] == "done"}
    cells, paths = {}, {}
    print(f"[exec sweep] {len(sweep)} cells in {sweep_s:.1f} s through 2 "
          f"workers on card 0 (cell 0 crashed and cell 1 hung on their "
          f"first attempts, {HANG_TIMEOUT_S} s timeout): {stats}; the "
          "workers' launches cannot be counted from this process, so each "
          f"cell is run again in process and counted [{card}]", flush=True)
    for rid, spec in sweep.expand():
        rec = done[rid]
        tm = rec["worker_timing"]
        reset_counts()
        here = run(spec, device=dev, log_every=1)
        paths[f"exec sweep {rid}"] = _counted(
            f"sweep {rid} in process", here, read_counts(),
            expected_counts(spec.aggregator, *_rounds(here.history)), card)
        same = (_history(srun.artifacts[rid]["history"])
                == _history(here.history)
                and srun.artifacts[rid]["comm_bits"] == here.comm_bits)
        print(f"[exec sweep {rid}] subprocess cell: {rec['wall_s']:.2f} s "
              f"from start to artifact ({rec['attempts']} attempt(s), "
              f"fault {rec['injected_fault']}); in the worker: import "
              f"{tm['import_s']:.2f} s, CUDA context {tm['cuda_init_s']:.2f}"
              f" s, experiment and data {tm['build_s']:.2f} s, run "
              f"{tm['run_s']:.2f} s of which the loop {tm['loop_s']:.2f} s "
              f"({tm['loop_s'] / SWEEP_STEPS * 1e3:.3f} ms per round); "
              f"artifact equal to the in-process run but wall_s: {same} "
              f"[{card}]", flush=True)
        if not same:
            raise AssertionError(f"exec sweep {rid}: the worker's history "
                                 "differs from the in-process run's")
        cells[rid] = {"wall_s": rec["wall_s"], "attempts": rec["attempts"],
                      "injected_fault": rec["injected_fault"],
                      "worker_timing": tm,
                      "in_process_ms": _ms_per_round(here)}
    before = summary.read_bytes()
    lost = "aggregator=rfa__seed=1"
    (out / f"{lost}.json").unlink()
    t0 = time.time()
    again = run_sweep(sweep, out_dir=str(out), pool=pool, resume=True,
                      summary_out=str(summary), log_every=1,
                      device=dev.type)
    resume_s = time.time() - t0
    same_bytes = summary.read_bytes() == before
    print(f"[exec sweep resume] {lost}'s artifact deleted: "
          f"{again.stats['executed_cells']} cell re-ran, "
          f"{len(again.skipped)} skipped, in {resume_s:.1f} s; summary "
          f"bytes equal: {same_bytes} [{card}]", flush=True)
    if (again.failures or again.stats["executed_cells"] != 1
            or lost not in again.artifacts or lost in again.skipped
            or not same_bytes):
        raise AssertionError(f"exec sweep resume: {again.stats}, "
                             f"failures {again.failures}, summary bytes "
                             f"equal {same_bytes}")
    group = list(Sweep(RunSpec(**{**MAIN_SPEC, "agg_mode": "gspmd",
                                  "steps": SWEEP_STEPS}),
                       {"seed": (0, 1, 2)}).expand())
    reset_counts()
    results, gstats = xc.run_group(group, log_every=1, device=dev)
    counts = read_counts()
    group_same = True
    for rid, spec in group:
        serial = run(spec, device=dev, log_every=1)
        got = results[rid]
        group_same &= (_history(got.history) == _history(serial.history)
                       and got.comm_bits == serial.comm_bits
                       and _states_equal(got.state, serial.state))
    ms = [_ms_per_round(results[rid]) for rid, _ in group]
    print(f"[exec gspmd group] seeds 0, 1, 2 over one experiment: "
          + " / ".join(f"{m:.3f}" for m in ms)
          + f" ms per round; equal to serial runs bit for bit: {group_same};"
          f" launches {nonzero(counts)} (gspmd runs no kernel) [{card}]",
          flush=True)
    if not group_same or nonzero(counts):
        raise AssertionError(f"exec gspmd group: equal {group_same}, "
                             f"launches {nonzero(counts)}")
    paths["exec gspmd group"] = {"launches": counts,
                                 "rounds": len(group) * SWEEP_STEPS,
                                 "per_round_ms": statistics.mean(ms)}
    return {"paths": paths, "cells": cells, "sweep_s": sweep_s,
            "resume_s": resume_s, "stats": stats,
            "summary_bytes_equal": same_bytes, "group_equal": group_same,
            "group_stats": gstats}


def exec_phase(dev, card) -> dict:
    import shutil
    t0 = time.time()
    ck_dir = ROOT / "build" / "chip_smoke_exec"
    sweep_dir = ROOT / "chiprun_out" / "exec_sweep"
    for d in (ck_dir, sweep_dir):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    got = {"resume": exec_resume(dev, card, ck_dir),
           "sweep": exec_sweep(dev, card, sweep_dir)}
    got["paths"] = {**got["resume"].pop("paths"),
                    **got["sweep"].pop("paths")}
    got["wall_s"] = time.time() - t0
    print(f"[exec] the phase took {got['wall_s']:.1f} s [{card}]",
          flush=True)
    return got


# the streaming service (repro_torch.serve): a9a-shaped clients under the
# reference tests' chaos (a quarter of the clients 4x slower, 10% of the
# updates lost, 25% delivered twice), every fire through the kernels
SERVE_FIRES = 60
SERVE_SPEC = dict(
    task="logreg", method="sgd", n_clients=32, n_byz=4, attack="ALIE",
    aggregator="cm", bucket_size=2, agg_mode="pallas", buffer_size=8,
    rounds=SERVE_FIRES, lr=0.5, arrival="exp", seed=0,
    arrival_kwargs={"mean_latency": 1.0, "straggler_frac": 0.25,
                    "straggler_factor": 4.0, "dropout": 0.1,
                    "duplicate": 0.25},
    data_kwargs=dict(MAIN_SPEC["data_kwargs"]))
SERVE_TRACED_FIRES = 20
# benchmarks/bench_serve.py's Krum K = 256 cell: the buffer bucketed to
# m = 128 rows takes the blocked tier
SERVE_GIANT_SPEC = dict(
    task="logreg", method="sgd", n_clients=512, n_byz=16, attack="ALIE",
    aggregator="krum", bucket_size=2, agg_mode="pallas", buffer_size=256,
    rounds=12, lr=0.1, arrival="exp", arrival_kwargs={"mean_latency": 1.0},
    data_kwargs={"dim": 1024, "n_samples": 128, "batch_size": 8})
# the sync limit: K = n, const latency, no chaos
SERVE_SYNC_SPEC = dict(SERVE_SPEC, n_clients=5, n_byz=1, buffer_size=5,
                       arrival="const", arrival_kwargs={}, rounds=20)
SERVE_RESUME_FIRES = 20
SERVE_KILL_EVENTS = 100          # the killed run's events: some 8 fires
SERVE_CHECK_FIRES = 12
SERVE_HOST = ("round", "t_virtual", "staleness_mean", "staleness_max",
              "byz_in_buffer", "delta_active", "cursor")
# the weighted operator on the card: W = W_bucket · diag(w) at the serve
# paths' shapes (8 buffered rows of a9a's packed b+w, 124 wide), W =
# diag(w) (m = n, unbucketed Krum) there, and both at n = 64, where the
# fused kernels' shared memory holds x, W x and W (64 x 64) together
SERVE_W_CASES = [
    ("dense", "serve cm: W_bucket·diag(w), 8 rows", 8, 124, None, 0, 2,
     "median"),
    ("dense", "serve krum: W = diag(w), 8 rows", 8, 124, None, 0, 1,
     "median"),
    ("dense", "W_bucket·diag(w), 64 rows, 2^18 wide", 64, 1 << 18, None, 0,
     2, "median"),
    ("dense", "W = diag(w), m = n = 64, 2^18 wide", 64, 1 << 18, None, 0, 1,
     "median"),
]


def _serve_counts(per_fire: dict, fires: int) -> dict:
    counts = dict.fromkeys(COUNTED, 0)
    for k, v in per_fire.items():
        counts[k] = v * fires
    return counts


def _serve_run(dev, spec, tag, per_fire, card, **run_kw):
    """One service run on the card, the counts set to 0 just before; its
    launches against ``per_fire`` times its fires."""
    from repro_torch.api import ServeSpec
    reset_counts()
    t0 = time.time()
    res = ServeSpec(**spec).run(device=dev, sync_each_fire=True, **run_kw)
    wall = time.time() - t0
    counts = read_counts()
    fires = len(res.history)
    want = _serve_counts(per_fire, fires)
    if counts != want:
        raise AssertionError(f"serve {tag}: launches {nonzero(counts)} "
                             f"for {fires} fires, expected {nonzero(want)}")
    losses = [m["loss"] for m in res.history]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"serve {tag}: non-finite loss")
    lat = [t * 1e3 for t in res.fire_latencies_s]
    row = {"fires": fires, "launches": counts, "run_wall_s": wall,
           "wall_ms_per_fire": res.wall_s / max(fires, 1) * 1e3,
           "fire_ms_p50": statistics.median(lat) if lat else None,
           "fire_ms_mean": statistics.mean(lat) if lat else None,
           "updates_per_s": res.updates_per_s, "stats": res.stats,
           "first_loss": losses[0] if losses else None,
           "final_loss": losses[-1] if losses else None}
    print(f"[serve {tag}] {fires} fires; fire {row['fire_ms_p50']:.3f} ms "
          f"p50, {row['fire_ms_mean']:.3f} ms mean (host clock around the "
          f"fire, the card synchronized after it); "
          f"{row['wall_ms_per_fire']:.3f} ms of the loop a fire (ingest, "
          f"client rounds and fire); run() {wall:.2f} s incl. data and "
          f"init; {res.updates_per_s:.1f} updates/s; launches "
          f"{nonzero(counts)}; stats {res.stats} [{card}]", flush=True)
    return res, row


def _serve_vs_cpu(tag, spec, res, traced=False):
    """The card run's first SERVE_CHECK_FIRES fires against the CPU run of
    the same spec: host fields equal, loss and |g| to TRAJ_TOL (and a
    traced run's influence, to TRAJ_TOL of its largest entry)."""
    from repro_torch.api import ServeSpec
    cpu = ServeSpec(**{**spec, "rounds": SERVE_CHECK_FIRES}).run(
        device="cpu")
    n = SERVE_CHECK_FIRES
    host = [{k: m[k] for k in SERVE_HOST} for m in res.history[:n]]
    if host != [{k: m[k] for k in SERVE_HOST} for m in cpu.history]:
        raise AssertionError(f"serve {tag}: host fields differ from the "
                             "CPU run")
    diff = max(abs(a[k] - b[k]) for a, b in zip(res.history, cpu.history)
               for k in ("loss", "g_norm"))
    if traced:
        for a, b in zip(res.traces, cpu.traces):
            top = max(max(abs(v) for v in b["influence"]), 1e-30)
            diff = max(diff, max(abs(x - y) for x, y in
                                 zip(a["influence"], b["influence"])) / top)
    print(f"[serve {tag}] first {n} fires vs the CPU run: host fields "
          f"equal, max |loss or |g| diff|{' or influence' if traced else ''}"
          f" {diff:.3e} (limit {TRAJ_TOL})", flush=True)
    if diff > TRAJ_TOL:
        raise AssertionError(f"serve {tag}: differs from the CPU run by "
                             f"{diff}")
    return diff


def _ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def serve_phase(dev, card) -> dict:
    """The streaming service on the card (module docstring): the weighted
    bucket operator in each fused kernel against its plain version, timed
    beside the same call unweighted, then the serve paths, each with its
    launches per fire and its first fires against the CPU run."""
    import shutil
    from repro_torch.api import RunSpec, ServeSpec, run
    from repro_torch.serve import params_digest
    t0 = time.time()
    rows, unweighted = [], []
    for c in SERVE_W_CASES:
        rows.append(kernel_case(c, dev, weighted=True))
        rows.extend(norm_case(c[:7], dev, weighted=True))
        # the same call with W the bucket operator alone (None unbucketed):
        # what the staleness weights cost the kernel
        unweighted.append(kernel_case(c, dev))
        unweighted.extend(norm_case(c[:7], dev))
    for a, b in zip(rows, unweighted):
        dm = [r["device_ms"] for r in (a, b)]
        print(f"[serve] {a['kernel']:12s} {a['label']}: weighted m={a['m']}"
              f" {a['ms']:.4f} ms (device {_ms_text(dm[0])}) against "
              f"unweighted m={b['m']} {b['ms']:.4f} ms (device "
              f"{_ms_text(dm[1])}): x{a['ms'] / b['ms']:.2f} [{card}]",
              flush=True)
    paths, checks = {}, {}
    cm = {"robust_agg/dense": 1}
    krum = {"pair_gram/dense": 1, "weighted_sum/dense": 1}
    res, paths["serve cm"] = _serve_run(dev, SERVE_SPEC, "cm", cm, card)
    checks["cm_vs_cpu"] = _serve_vs_cpu("cm", SERVE_SPEC, res)
    weighted = sum(m["staleness_max"] > 0 for m in res.history)
    if not weighted:
        raise AssertionError("serve cm: no fire carried staleness weights")
    spec = {**SERVE_SPEC, "aggregator": "krum", "bucket_size": 0,
            "rounds": SERVE_TRACED_FIRES}
    plain, paths["serve krum"] = _serve_run(dev, spec, "krum", krum, card)
    traced, paths["serve krum traced"] = _serve_run(
        dev, {**spec, "trace": True}, "krum traced", krum, card)
    same = (_states_equal(plain.params, traced.params)
            and [(m["loss"], m["g_norm"]) for m in plain.history]
            == [(m["loss"], m["g_norm"]) for m in traced.history])
    print(f"[serve krum traced] equal to its untraced twin bit for bit: "
          f"{same}; influence sums "
          f"{[round(sum(t['influence']), 4) for t in traced.traces[:8]]} "
          f"... [{card}]", flush=True)
    if not same:
        raise AssertionError("serve krum: the traced run differs from its "
                             "untraced twin")
    checks["krum_traced_vs_cpu"] = _serve_vs_cpu(
        "krum traced", {**spec, "trace": True}, traced, traced=True)
    giant, paths["serve giant"] = _serve_run(
        dev, SERVE_GIANT_SPEC, "giant krum K=256",
        {"pair_gram_blocked": 2, "weighted_sum_blocked": 2}, card)
    checks["giant_vs_cpu"] = _serve_vs_cpu("giant krum K=256",
                                           SERVE_GIANT_SPEC, giant)
    sync, paths["serve sync"] = _serve_run(dev, SERVE_SYNC_SPEC, "sync", cm,
                                           card)
    eng = run(ServeSpec(**SERVE_SYNC_SPEC).to_run_spec(), device=dev,
              log_every=1)
    sync_same = (_states_equal(sync.params, eng.state["params"])
                 and [m["loss"] for m in sync.history]
                 == [m["loss"] for m in eng.history])
    print(f"[serve sync] K = n = 5, const latency: equal to the synchronous "
          f"run (api.run of to_run_spec()) bit for bit: {sync_same} "
          f"[{card}]", flush=True)
    if not sync_same:
        raise AssertionError("serve sync: differs from the synchronous run")
    checks["sync_vs_cpu"] = _serve_vs_cpu("sync", SERVE_SYNC_SPEC, sync)
    out = ROOT / "build" / "chip_smoke_serve"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    spec = {**SERVE_SPEC, "rounds": SERVE_RESUME_FIRES}
    full, paths["serve resume uninterrupted"] = _serve_run(
        dev, spec, "resume: uninterrupted", cm, card)
    prefix = [(m["loss"], m["g_norm"]) for m in res.history[
        :SERVE_RESUME_FIRES]]
    if [(m["loss"], m["g_norm"]) for m in full.history] != prefix:
        raise AssertionError("serve resume: the uninterrupted run does not "
                             "repeat the cm path's first fires")
    killed, paths["serve resume killed"] = _serve_run(
        dev, spec, "resume: killed", cm, card, checkpoint=str(out / "ck"),
        checkpoint_every=5, stop_after_events=SERVE_KILL_EVENTS)
    resumed, paths["serve resume resumed"] = _serve_run(
        dev, spec, "resume: resumed", cm, card, resume=str(out / "ck"))
    digests = [params_digest(r.params) for r in (full, resumed)]
    print(f"[serve resume] killed after {SERVE_KILL_EVENTS} events at "
          f"{killed.stats['rounds']} fires, resumed from the checkpoint of "
          f"fire {resumed.history[0]['round']}: params_digest "
          f"{digests[1]} against the uninterrupted run's {digests[0]} "
          f"[{card}]", flush=True)
    if digests[0] != digests[1] or resumed.stats != full.stats:
        raise AssertionError("serve resume: the resumed run ends apart "
                             "from the uninterrupted one")
    got = {"weighted_cases": rows, "unweighted_cases": unweighted,
           "paths": paths, "checks": checks,
           "cm_weighted_fires": weighted,
           "wall_s": time.time() - t0}
    print(f"[serve] the phase took {got['wall_s']:.1f} s [{card}]",
          flush=True)
    return got


# the LM phase: Byz-VR-MARINA + RandK + ALIE + cm (s = 2) on qwen3-1.7b at
# full width (bfloat16, 28 layers), 5 workers, 4 sequences of 128 tokens a
# worker, through api.run and launch.train
LM_SPEC = dict(task="lm", arch="qwen3-1.7b", method="marina", p=0.1,
               n_workers=5, n_byz=1, attack="ALIE", aggregator="cm",
               bucket_size=2, compressor="randk",
               compressor_kwargs={"ratio": 0.1}, agg_mode="pallas", lr=3e-3,
               data_kwargs={"seq_len": 128, "per_worker_batch": 4})
LM_TOKENS = 5 * 4 * 128            # tokens a round
LM_STEPS = 4                       # a warm round, then 3 timed
LM_REPEAT_STEPS = 3                # rounds run twice, equal bit for bit
LM_TWIN_STEPS = 6                  # the reduced float32 twin against the CPU
LM_CLI_STEPS = 1
LM_LEAVES = 14                     # leaves, each wider than SMALL_LEAF_D
LM_PLAIN_BLOCK = 1 << 24           # columns a plain-version comparison takes
# robust_agg's dense bf16 load at the LM leaves' widths: (kind, label, n,
# d, k, base rows, s, rule); the 8-worker case crosses 2^31 elements
LM_KERNEL_CASES = [
    ("dense_bf16", "qwen3-1.7b stacked ffn w1 28x2048x6144, bf16, 8 "
     "workers", 8, 352_321_536, None, 0, 2, "median"),
    ("dense_bf16", "qwen3-1.7b stacked ffn w1 28x2048x6144, bf16 (the LM "
     "path's widest leaf)", 5, 352_321_536, None, 0, 2, "median"),
    ("dense_bf16", "qwen3-1.7b stacked q_proj 28x2048x2048, bf16 (the LM "
     "path's)", 5, 117_440_512, None, 0, 2, "median"),
]
# the lm_moe phase: the same spec on deepseek-v2-lite-16b at its published
# widths (MLA, 64 routed experts of 1408 with top-6 and 2 shared, vocab
# 102,400, bfloat16), its 27 layers cut to 3 (2,173,976,064 parameters;
# the 27 layers' 16.2e9 do not fit on one 80 GB card), registered here
# under a name that states the cut
LM_MOE_ARCH = "deepseek-v2-lite-16b-3l"
LM_MOE_LAYERS = 3
LM_MOE_SPEC = dict(LM_SPEC, arch=LM_MOE_ARCH)
LM_MOE_STEPS = 6                   # a warm round, then 5 timed
LM_MOE_LEAVES = 19                 # leaves, each wider than SMALL_LEAF_D
LM_MOE_TWINS = ("deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b")
LM_MOE_KERNEL_CASES = [
    ("dense_bf16", "deepseek-v2-lite-16b-3l stacked expert w1 "
     "3x64x2048x1408, bf16 (the lm_moe path's widest leaf)", 5,
     553_648_128, None, 0, 2, "median"),
    ("dense_bf16", "phi3.5-moe-42b-a6.6b expert w1 at one layer "
     "1x16x4096x6400, bf16", 5, 419_430_400, None, 0, 2, "median"),
]


# the lm_ssm phase: the same spec on mamba2-130m at full width (24 SSD
# blocks, tied embeddings, bfloat16, 128,940,480 parameters: no cut) and on
# recurrentgemma-2b at its published widths (RG-LRU width 2560, one
# sliding-window block of 10 heads of 256 and one KV head per group, vocab
# 256,000, bfloat16) cut from 26 to 8 layers, 2 groups and the 2-block
# tail (2,008,174,080 parameters; the 26 layers' 3,549,888,000 do not fit
# on one 80 GB card at the LM path's 32 bytes a parameter)
LM_SSM_MAMBA = "mamba2-130m"
LM_SSM_RG_ARCH = "recurrentgemma-2b-8l"
LM_SSM_RG_LAYERS = 8
LM_SSM_TWINS = ("mamba2-130m", "recurrentgemma-2b")
LM_SSM_STEPS = 4                   # a warm round, then 3 timed
# robust_agg launches an aggregation, by load: every leaf of at least
# SMALL_LEAF_D columns is its own bf16 segment, and leaves under it pack
# into one float32 segment. mamba2-130m: 6 leaves of 18,432 (norm1) to
# 61,784,064 (w_in) columns, and final_norm, a_log, d_skip, dt_bias (768,
# 576, 576, 576) packed; recurrentgemma-2b-8l: 68 leaves of 2,560 to
# 655,360,000, none packed. Each tree has leaves over RandK's 2^22 units,
# so every VR round aggregates dense, off the wire.
LM_SSM_MAMBA_SEGMENTS = {"dense_bf16": 6, "dense": 1}
LM_SSM_RG_SEGMENTS = {"dense_bf16": 68}
LM_SSM_KERNEL_CASES = [
    ("dense_bf16", "recurrentgemma-2b embed and unembed 256000x2560, bf16 "
     "(the lm_ssm path's widest leaves)", 5, 655_360_000, None, 0, 2,
     "median"),
]


def register_ssm_cut():
    """Register recurrentgemma-2b cut to LM_SSM_RG_LAYERS layers as
    LM_SSM_RG_ARCH (widths, heads, window and vocabulary as published)."""
    import dataclasses
    from repro_torch.configs import get_config, register
    register(dataclasses.replace(get_config("recurrentgemma-2b"),
                                 name=LM_SSM_RG_ARCH,
                                 num_layers=LM_SSM_RG_LAYERS))


def lm_segments(arch) -> dict:
    """{load: robust_agg launches an aggregation} of ``arch``'s tree by
    the packing rule of ``sharded_agg._segments``, from its shapes."""
    from repro_torch.configs import get_config
    from repro_torch.core.sharded_agg import SMALL_LEAF_D
    from repro_torch.models import param_shapes
    cfg = get_config(arch)
    sizes = [math.prod(s) for s in param_shapes(cfg).values()]
    small = sum(1 for d in sizes if d < SMALL_LEAF_D)
    load = "dense_bf16" if cfg.dtype == "bfloat16" else "dense"
    out = {load: len(sizes) - (small if small >= 2 else 0)}
    if small >= 2:
        out["dense"] = out.get("dense", 0) + 1
    return out


def register_moe_cut():
    """Register deepseek-v2-lite-16b cut to LM_MOE_LAYERS layers as
    LM_MOE_ARCH (widths, experts and routing as published)."""
    import dataclasses
    from repro_torch.configs import get_config, register
    register(dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                                 name=LM_MOE_ARCH, num_layers=LM_MOE_LAYERS))


def _lm_counts(aggregations: int, segments: dict, wire_rounds: int = 0,
               leaves: int = 0) -> dict:
    """Launches of an LM run: each dense aggregation (the init's, and a
    round's) is one robust_agg launch a segment (a leaf in its dtype's
    load, or the leaves under SMALL_LEAF_D packed into one float32
    segment): ``segments`` maps each load to its segments. A VR round on
    the RandK wire (every leaf of at most 2^22 coordinates: the reduced
    twins) is one launch a leaf. At full width a leaf over 2^22 takes
    RandK's block selection, and the whole tree's VR rounds go dense."""
    counts = dict.fromkeys(COUNTED, 0)
    for load, n in segments.items():
        _add(counts, "robust_agg", load, n * aggregations)
    _add(counts, "robust_agg", "sparse", leaves * wire_rounds)
    return counts


class _PlainCheck:
    """While ``on``, every robust_agg call of the LM path is held to
    robust_agg_plain on the same inputs, LM_PLAIN_BLOCK columns at a time
    (the plain version's float32 copies of a 5 x 352 M stack would not fit
    beside the round's own); the kernel's launch is the round's own."""

    def __init__(self):
        from repro_torch.core import sharded_agg
        self.mod, self.real = sharded_agg, sharded_agg.robust_agg
        self.on, self.rows = False, []

    def __enter__(self):
        self.mod.robust_agg = self
        return self

    def __exit__(self, *exc):
        self.mod.robust_agg = self.real

    def __call__(self, x, w_mat, mask, mu, sd, valid, bvalid, **kw):
        from repro_torch.kernels.robust_agg import robust_agg_plain
        got = self.real(x, w_mat, mask, mu, sd, valid, bvalid, **kw)
        if not self.on:
            return got
        n, d = x.shape
        err, scale = 0.0, 1.0
        for c in range(0, d, LM_PLAIN_BLOCK):
            sl = slice(c, c + LM_PLAIN_BLOCK)
            xs = x[:, sl]
            want = robust_agg_plain(xs, w_mat, mask, mu[sl], sd[sl], valid,
                                    bvalid, **kw)
            err = max(err, float((got[sl] - want).abs().max()))
            scale = max(scale, float(xs.abs().max()),
                        float(mu[sl].abs().max())
                        + kw["attack"].param * float(sd[sl].max()))
            del xs, want
        self.rows.append({"n": n, "d": d, "dtype": str(x.dtype),
                          "max_abs_err": err, "limit": KERNEL_TOL * scale})
        return got


def _lm_run(dev, spec, steps, tag, card, keep_at=None, plain=None,
            plain_from=None):
    """``api.run`` of an LM spec on the card, each round's host time taken
    in the callback (every round's metrics are read, so each ends on a
    device sync); ``keep_at``: the round after which params and g are
    copied to the host; ``plain``: a _PlainCheck turned on for round
    ``plain_from``. -> (result, round ms, counts, kept, peak bytes)."""
    from repro_torch.api import RunSpec, run
    marks, kept = [], {}

    def cb(it, state, m):
        marks.append(time.perf_counter())
        if it == keep_at:
            kept.update({f"{part}/{k}": v.cpu() for part in ("params", "g")
                         for k, v in state[part].items()})
        if plain is not None:
            plain.on = it + 1 == plain_from
        return False

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    res = run(RunSpec(**{**spec, "steps": steps}), device=dev, log_every=1,
              callback=cb, callback_every=1)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    round_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    losses = [h["loss"] for h in res.history]
    full, vr = _rounds(res.history)
    print(f"[lm {tag}] {len(losses)} rounds ({full} full, {vr} VR), run() "
          f"wall {wall:.2f} s incl. init; losses "
          f"{[round(v, 6) for v in losses]}; peak "
          f"{peak / 2**30:.2f} GiB allocated; launches {nonzero(counts)} "
          f"[{card}]", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"lm {tag}: a loss is not finite: {losses}")
    return res, round_ms, counts, kept, peak


def _twin_spec(arch) -> dict:
    """LM_SPEC on ``arch``'s reduced float32 twin."""
    return {**LM_SPEC, "arch": arch,
            "data_kwargs": {**LM_SPEC["data_kwargs"], "reduced": True}}


def _lm_twin(dev, card, arch) -> dict:
    """The reduced float32 twin of ``arch`` under LM_SPEC on the card,
    its launches exact, and its first LM_TWIN_STEPS rounds against the
    CPU path (c_k equal, losses within TRAJ_TOL)."""
    from repro_torch.api import RunSpec, run
    from repro_torch.configs import get_config
    from repro_torch.core.sharded_agg import SMALL_LEAF_D
    from repro_torch.models import param_shapes
    tag = f"lm {arch} reduced twin"
    twin = _twin_spec(arch)
    sizes = [math.prod(s)
             for s in param_shapes(get_config(arch).reduced()).values()]
    small = sum(1 for d in sizes if d < SMALL_LEAF_D)
    segs = len(sizes) - small + (1 if small >= 2 else 0)
    res, _, counts, _, _ = _lm_run(dev, twin, LM_TWIN_STEPS, tag[3:], card)
    full, vr = _rounds(res.history)
    want = _lm_counts(1 + full, {"dense": segs}, vr, len(sizes))
    if counts != want:
        raise AssertionError(f"{tag}: launches {nonzero(counts)}, expected "
                             f"{nonzero(want)}")
    cpu_hist = CPU_RUNS.history({**twin, "steps": LM_TWIN_STEPS})
    ck = [int(h["c_k"]) for h in res.history]
    cpu_ck = [int(h["c_k"]) for h in cpu_hist]
    diff = float(np.max(np.abs(np.array([h["loss"] for h in res.history])
                               - np.array([h["loss"] for h in cpu_hist]))))
    print(f"[{tag}] {LM_TWIN_STEPS} rounds vs the CPU plain path: c_k {ck} "
          f"(CPU {cpu_ck}), max |loss diff| {diff:.3e} (limit {TRAJ_TOL}) "
          f"[{card}]", flush=True)
    if ck != cpu_ck or not diff <= TRAJ_TOL:
        raise AssertionError(f"{tag}: differs from the CPU path by {diff}")
    return {"launches": counts, "cpu_loss_diff": diff}


def _lm_full_width(dev, card, spec, steps, segments, cut) -> tuple:
    """``spec``'s arch at full width through api.run: ``steps`` rounds
    (the launches exact: ``segments`` robust_agg launches an aggregation
    by load, the init's included; ms a round p50 over the rounds
    after the first, tokens a second, peak memory), then the first
    LM_REPEAT_STEPS rounds again, equal bit for bit (params and g), with
    the last of them held to the plain versions leaf by leaf. ``cut``
    states the depth. -> (row, {path: launches}, the repeat's params, for
    the decode check; the rest of its state freed)."""
    arch = spec["arch"]
    res, round_ms, counts, kept, peak = _lm_run(dev, spec, steps, arch, card,
                                                keep_at=LM_REPEAT_STEPS - 1)
    want = _lm_counts(1 + steps, segments)
    leaves = sum(segments.values())
    if counts != want:
        raise AssertionError(f"lm {arch}: launches {nonzero(counts)}, "
                             f"expected {nonzero(want)}: an aggregation "
                             "bypassed its kernel")
    timed = round_ms[-(steps - 1):]
    p50 = statistics.median(timed)
    full, vr = _rounds(res.history)
    row = {"arch": arch, "depth": cut, "n_params": res.n_params,
           "rounds": steps, "full_rounds": full, "vr_rounds": vr,
           "round_ms": round_ms, "ms_per_round_p50": p50,
           "tokens_per_s": LM_TOKENS / p50 * 1e3, "peak_bytes": peak,
           "launches_per_round": leaves,
           "losses": [h["loss"] for h in res.history]}
    print(f"[lm {arch}] full width, {cut}, {res.n_params} parameters, "
          f"bfloat16; {full} full and {vr} VR rounds; ms per round p50 "
          f"{p50:.3f} over {len(timed)} timed rounds after a warm one (host "
          f"clock, each round ending on a device read; all "
          f"{[round(t, 3) for t in round_ms]}); {row['tokens_per_s']:.1f} "
          f"tokens/s ({LM_TOKENS} a round); peak "
          f"{peak / 2**30:.2f} GiB allocated (torch.cuda."
          f"max_memory_allocated); launches {segments} robust_agg a round, "
          f"{nonzero(counts)} in all [{card}]", flush=True)
    del res
    with _PlainCheck() as plain:
        res, _, counts2, _, peak2 = _lm_run(
            dev, spec, LM_REPEAT_STEPS, f"{arch} repeat", card, plain=plain,
            plain_from=LM_REPEAT_STEPS - 1)
    same = all(torch.equal(kept[f"{part}/{k}"], v.cpu())
               for part in ("params", "g") for k, v in res.state[part].items())
    if not same:
        raise AssertionError(f"lm {arch}: the first rounds do not repeat bit "
                             "for bit")
    if counts2 != _lm_counts(1 + LM_REPEAT_STEPS, segments):
        raise AssertionError(f"lm {arch} repeat: launches {nonzero(counts2)}")
    bad = [r for r in plain.rows if not r["max_abs_err"] <= r["limit"]]
    if len(plain.rows) != leaves or bad:
        raise AssertionError(f"lm {arch}: round {LM_REPEAT_STEPS - 1}'s "
                             f"aggregation against the plain versions: "
                             f"{len(plain.rows)} leaves, off {bad}")
    worst = max(r["max_abs_err"] / r["limit"] for r in plain.rows)
    print(f"[lm {arch}] the first {LM_REPEAT_STEPS} rounds again: params "
          f"and g equal bit for bit; round {LM_REPEAT_STEPS - 1}'s "
          f"{len(plain.rows)} leaves ({sum(r['d'] for r in plain.rows)} "
          f"columns) held to robust_agg_plain on the card, worst err "
          f"{worst:.3e} of KERNEL_TOL x scale [{card}]", flush=True)
    row.update(repeat_bitwise=True, plain_rows=plain.rows,
               repeat_peak_bytes=peak2)
    params = res.state["params"]
    del res, kept
    torch.cuda.empty_cache()
    return row, {f"lm {arch}": {"launches": counts},
                 f"lm {arch} repeat": {"launches": counts2}}, params


def _lm_cli(card, arch, segments) -> dict:
    """LM_CLI_STEPS rounds of LM_SPEC on ``arch`` through
    ``launch.train.main`` in process, launches exact."""
    from repro_torch.launch import train
    args = ["--arch", arch, "--method", "marina", "--p", "0.1",
            "--n-workers", "5", "--n-byz", "1", "--attack", "ALIE", "--agg",
            "cm", "--bucket-size", "2", "--compressor", "randk",
            "--compressor-kwargs", '{"ratio": 0.1}', "--agg-mode", "pallas",
            "--lr", "3e-3", "--seq-len", "128", "--per-worker-batch", "4",
            "--steps", str(LM_CLI_STEPS), "--log-every", "1"]
    torch.cuda.empty_cache()
    reset_counts()
    hist = train.main(args)
    counts = read_counts()
    if counts != _lm_counts(1 + LM_CLI_STEPS, segments) or \
            not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"lm launch.train {arch}: launches "
                             f"{nonzero(counts)}, losses "
                             f"{[h['loss'] for h in hist]}")
    print(f"[lm launch.train] {arch}: {len(hist)} rounds in process, losses "
          f"{[round(h['loss'], 6) for h in hist]}, launches "
          f"{nonzero(counts)} [{card}]", flush=True)
    torch.cuda.empty_cache()
    return {"launches": counts}


def lm_phase(dev, card) -> dict:
    """The LM slice on the card: robust_agg's bf16 load at the LM leaves'
    widths against its plain version; the reduced float32 twin against the
    CPU path; qwen3-1.7b at full width through api.run (launches a round
    exact, ms a round, tokens a second, peak memory), its first rounds
    again, bit for bit, with one round's aggregation held to the plain
    versions leaf by leaf; launch.train.main in process; and decoding
    (``_decode``) on the full-width run's parameters and the twin's."""
    t_phase = time.time()
    out = {"kernel_rows": [kernel_case(c, dev) for c in LM_KERNEL_CASES]}
    out["paths"] = {"lm reduced twin": _lm_twin(dev, card, "qwen3-1.7b")}
    row, paths, params = _lm_full_width(dev, card, LM_SPEC, LM_STEPS,
                                        {"dense_bf16": LM_LEAVES},
                                        "28 layers (no depth cut)")
    out["paths"].update(paths)
    out["decode"], paths = _decode(dev, card, "qwen3-1.7b", params,
                                   "qwen3-1.7b")
    out["paths"].update(paths)
    del params
    out["paths"]["lm launch.train"] = _lm_cli(card, "qwen3-1.7b",
                                              {"dense_bf16": LM_LEAVES})
    out["full_width"] = row
    out["phase_s"] = time.time() - t_phase
    print(f"[lm] phase {out['phase_s']:.1f} s [{card}]", flush=True)
    return out


def lm_moe_phase(dev, card) -> dict:
    """The MLA and MoE slice on the card: robust_agg's bf16 load at the
    widest expert stacks (deepseek-v2-lite-16b-3l's, phi3.5-moe's at one
    layer) against its plain version; the reduced float32 twins of
    deepseek-v2-lite-16b and phi3.5-moe against the CPU path; deepseek at
    full width, cut to LM_MOE_LAYERS layers, through api.run as the LM
    phase runs qwen3-1.7b, and through launch.train.main; decoding as
    the LM phase's, without the float32 check."""
    t_phase = time.time()
    register_moe_cut()
    out = {"kernel_rows": [kernel_case(c, dev) for c in LM_MOE_KERNEL_CASES]}
    out["paths"] = {f"lm {arch} reduced twin": _lm_twin(dev, card, arch)
                    for arch in LM_MOE_TWINS}
    row, paths, params = _lm_full_width(
        dev, card, LM_MOE_SPEC, LM_MOE_STEPS, {"dense_bf16": LM_MOE_LEAVES},
        f"{LM_MOE_LAYERS} of 27 layers (depth cut; every width, the 64 "
        "routed and 2 shared experts, top-6 and vocab as published)")
    out["paths"].update(paths)
    # no float32 check: the MoE capacity int(1.25 t k / e) + 1 counts the
    # step's B tokens, so a decode step drops what the forward keeps
    out["decode"], paths = _decode(dev, card, LM_MOE_ARCH, params,
                                   "deepseek-v2-lite-16b", f32_check=False)
    out["paths"].update(paths)
    del params
    out["paths"][f"lm launch.train {LM_MOE_ARCH}"] = _lm_cli(
        card, LM_MOE_ARCH, {"dense_bf16": LM_MOE_LEAVES})
    out["full_width"] = row
    out["phase_s"] = time.time() - t_phase
    print(f"[lm_moe] phase {out['phase_s']:.1f} s [{card}]", flush=True)
    return out


def lm_ssm_phase(dev, card) -> dict:
    """The Mamba2 SSD and RG-LRU slice on the card: robust_agg's bf16 load
    at recurrentgemma-2b's embedding width against its plain version; the
    reduced float32 twins of mamba2-130m and recurrentgemma-2b against the
    CPU path; mamba2-130m at full width (no depth cut) through api.run as
    the LM phase runs qwen3-1.7b, and through launch.train.main; and
    recurrentgemma-2b at its published widths cut to LM_SSM_RG_LAYERS
    layers through api.run. The launches an aggregation are the packing
    rule's (``lm_segments``), checked against the stated counts. Each
    model then decodes as the LM phase's, and ``launch.serve.main`` runs
    after mamba2-130m's."""
    t_phase = time.time()
    register_ssm_cut()
    for arch, want in ((LM_SSM_MAMBA, LM_SSM_MAMBA_SEGMENTS),
                       (LM_SSM_RG_ARCH, LM_SSM_RG_SEGMENTS)):
        if lm_segments(arch) != want:
            raise AssertionError(f"{arch}: segments {lm_segments(arch)}, "
                                 f"stated {want}")
    out = {"kernel_rows": [kernel_case(c, dev) for c in LM_SSM_KERNEL_CASES]}
    out["paths"] = {f"lm {arch} reduced twin": _lm_twin(dev, card, arch)
                    for arch in LM_SSM_TWINS}
    rows, out["decode"] = {}, {}
    for arch, segments, cut in (
            (LM_SSM_MAMBA, LM_SSM_MAMBA_SEGMENTS,
             "24 layers (no depth cut)"),
            (LM_SSM_RG_ARCH, LM_SSM_RG_SEGMENTS,
             f"{LM_SSM_RG_LAYERS} of 26 layers (depth cut: 2 groups of "
             "RG-LRU, RG-LRU, local attention and the 2-block tail; every "
             "width, the heads, the window and vocab as published)")):
        rows[arch], paths, params = _lm_full_width(
            dev, card, dict(LM_SPEC, arch=arch), LM_SSM_STEPS, segments, cut)
        out["paths"].update(paths)
        twin = LM_SSM_MAMBA if arch == LM_SSM_MAMBA else "recurrentgemma-2b"
        out["decode"][arch], paths = _decode(dev, card, arch, params, twin)
        out["paths"].update(paths)
        del params
        if arch == LM_SSM_MAMBA:
            out["paths"]["decode launch.serve"] = _serve_cli(card)
    out["paths"][f"lm launch.train {LM_SSM_MAMBA}"] = _lm_cli(
        card, LM_SSM_MAMBA, LM_SSM_MAMBA_SEGMENTS)
    out["full_width"] = rows
    out["phase_s"] = time.time() - t_phase
    print(f"[lm_ssm] phase {out['phase_s']:.1f} s [{card}]", flush=True)
    return out


# decoding at the end of each LM phase: ``launch.serve.generate``, greedy,
# at the serve CLI's defaults (4 sequences, a 16-token prompt fed through
# decode steps, 32 generated), on the parameters the phase's last
# full-width run left
DECODE_BATCH, DECODE_PROMPT, DECODE_GEN = 4, 16, 32
DECODE_SEED = 0
DECODE_ATOL, DECODE_RTOL = 2e-4, 2e-3  # decode against the forward, as
#                                      the reference's tests/test_decode.py
DECODE_TWIN_TOL = 2e-5                 # x the step's largest |logit|
DECODE_RESP_FACTOR = 8                 # x the forward's rounding response
DECODE_TWINS = ("qwen3-1.7b", "deepseek-v2-lite-16b", "mamba2-130m",
                "recurrentgemma-2b")


class _Steps:
    """While entered, ``launch.serve``'s ``decode_step`` is wrapped: it
    keeps each step's logits (``keep_all``) or the last, and on the card
    records CUDA events around each step (no host read between steps)."""

    def __init__(self, keep_all=False, timed=False):
        self.keep_all, self.timed = keep_all, timed
        self.logits, self.marks, self.last = [], [], None

    def __enter__(self):
        from repro_torch.launch import serve
        self.mod, self.real = serve, serve.decode_step
        serve.decode_step = self
        return self

    def __exit__(self, *exc):
        self.mod.decode_step = self.real

    def __call__(self, params, cfg, cache, tokens):
        if self.timed:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
        logits, cache = self.real(params, cfg, cache, tokens)
        if self.timed:
            b.record()
            self.marks.append((a, b))
        if self.keep_all:
            self.logits.append(logits)
        self.last = logits
        return logits, cache

    def step_ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.marks]


def _decode_prompt(cfg, device):
    """The serve CLI's prompt: ``randint`` under the seed's key."""
    from repro_torch import random as R
    return R.randint(R.PRNGKey(DECODE_SEED, device=device),
                     (DECODE_BATCH, DECODE_PROMPT), 0, cfg.vocab_size)


def _decode_twin_run(arch, device="cpu", threads=None) -> tuple:
    """Greedy ``generate`` of ``arch``'s reduced float32 twin, its
    parameters and prompt made on the CPU from DECODE_SEED, on ``device``
    -> (tokens, every step's logits) as numpy."""
    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    if threads is not None:
        torch.set_num_threads(threads)
    cfg = get_config(arch).reduced()
    params = {k: v.to(device) for k, v in
              init_params(R.PRNGKey(DECODE_SEED), cfg).items()}
    prompt = _decode_prompt(cfg, "cpu").to(device)
    with _Steps(keep_all=True) as steps:
        out = serve.generate(cfg, params, prompt, DECODE_GEN)
    return (out.cpu().numpy(),
            torch.stack(steps.logits, 1).float().cpu().numpy())


def _decode_twin(dev, card, arch) -> dict:
    """The reduced float32 twin's decode on the card against the CPU
    path: greedy tokens equal, each step's logits within DECODE_TWIN_TOL
    of that step's largest |logit|; no kernel launch."""
    reset_counts()
    toks, logits = _decode_twin_run(arch, dev)
    counts = read_counts()
    want_toks, want = CPU_RUNS.result(f"decode {arch}", _decode_twin_run,
                                      arch)
    scale = np.abs(want).max(axis=(0, 2))            # (B, step, V)
    worst = float((np.abs(logits - want).max(axis=(0, 2)) / scale).max())
    print(f"[decode {arch} reduced twin] {DECODE_BATCH} x "
          f"({DECODE_PROMPT} + {DECODE_GEN}) tokens vs the CPU plain path: "
          f"tokens equal {np.array_equal(toks, want_toks)}, worst logit err "
          f"{worst:.3e} of the step's largest |logit| (limit "
          f"{DECODE_TWIN_TOL}); launches {nonzero(counts)} [{card}]",
          flush=True)
    if not np.array_equal(toks, want_toks) or not worst <= DECODE_TWIN_TOL:
        raise AssertionError(f"decode {arch} twin: differs from the CPU "
                             f"path (logit err {worst})")
    if nonzero(counts):
        raise AssertionError(f"decode {arch} twin: launches "
                             f"{nonzero(counts)}")
    return {"launches": counts, "worst_logit_err": worst}


def _block_overs(cfg, params, seq) -> list:
    """Each block's teacher-forced decode against its own forward on the
    forward's input to it (so no block inherits another's rounding):
    per block in depth order, max(|decode - forward| - DECODE_RTOL
    |forward|) over the sequence."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    pat, n_groups, tail = T._split_depth(cfg)
    blocks = [(f"groups/{j}/", r, kind) for r in range(n_groups)
              for j, kind in enumerate(pat)]
    blocks += [(f"tail/{i}/", None, kind) for i, kind in enumerate(tail)]
    b, s = seq.shape[:2]
    x = M._embed(params, cfg, seq)
    positions = M._positions(cfg, {"tokens": seq}, s, seq.device)
    aux = torch.zeros((), dtype=torch.float32, device=seq.device)
    overs = []
    for prefix, r, kind in blocks:
        bp = L.subtree(params, prefix)
        if r is not None:
            bp = {k: v[r] for k, v in bp.items()}
        y, aux = T._apply_block(bp, cfg, kind, x, positions, aux)
        cache = T._init_block_cache(cfg, kind, b, s, seq.device)
        dec = []
        for t in range(s):
            o, cache = T._decode_block(bp, cfg, kind, x[:, t:t + 1], cache)
            dec.append(o)
        dec = torch.cat(dec, 1)
        overs.append(float(((dec - y).abs() - DECODE_RTOL * y.abs()).max()))
        x = y
    return overs


def _rounding_response(cfg, params, seq, full) -> tuple:
    """How far the float32 forward itself moves when its embedding table
    is perturbed at float32's rounding scale (each entry times 1 ± 2⁻²³,
    the sign from a seeded draw) -> (max |logits - ``full``|, max of
    |logits - ``full``| - DECODE_RTOL |``full``|)."""
    from repro_torch.models import forward
    gen = torch.Generator(device=seq.device).manual_seed(DECODE_SEED)
    emb = params["embed"]
    sign = torch.randint(0, 2, emb.shape, generator=gen,
                         device=emb.device).to(emb.dtype) * 2 - 1
    pert = dict(params, embed=emb * (1 + sign * 2.0 ** -23))
    del sign
    moved, _ = forward(pert, cfg, {"tokens": seq, "labels": seq})
    err = (moved - full).abs()
    return float(err.max()), float((err - DECODE_RTOL * full.abs()).max())


def _decode_f32(cfg, params, seq, arch, card) -> dict:
    """``params`` upcast to float32 and ``seq`` teacher-forced through
    decode steps against the float32 forward on the card. Every block's
    own decode (``_block_overs``) must hold DECODE_ATOL / DECODE_RTOL, and
    so must the logits; but where the float32 forward itself leaves that
    tolerance when its embedding moves by one rounding
    (``_rounding_response``), so that no float32 sum in another order
    could meet it, the logits' gap is held to DECODE_RESP_FACTOR times
    that response instead."""
    import dataclasses
    from repro_torch.models import decode_step, forward, init_cache
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    b, s = seq.shape[:2]
    cache = init_cache(cfg32, b, s, seq.device)
    dec = []
    for t in range(s):
        lg, cache = decode_step(p32, cfg32, cache, seq[:, t])
        dec.append(lg)
    dec = torch.stack(dec, 1)
    full, _ = forward(p32, cfg32, {"tokens": seq, "labels": seq})
    gap = float((dec - full).abs().max())
    over = float(((dec - full).abs() - DECODE_RTOL * full.abs()).max())
    resp, resp_over = _rounding_response(cfg32, p32, seq, full)
    del dec, cache
    blocks = _block_overs(cfg32, p32, seq)
    del p32, full
    torch.cuda.empty_cache()
    conditioned = resp_over > DECODE_ATOL
    held = (gap <= DECODE_RESP_FACTOR * resp if conditioned
            else over <= DECODE_ATOL)
    print(f"[decode {arch}] float32 (parameters upcast), {s} teacher-forced "
          f"steps against the float32 forward on the card: logits max "
          f"|err| {gap:.3e}, max of |err| - rtol |forward| {over:.3e}; the "
          f"forward's own move under a one-rounding embedding change "
          f"{resp:.3e}; each of {len(blocks)} blocks' decode on its forward "
          f"input: max of |err| - rtol |forward| {max(blocks):.3e} (limit "
          f"atol {DECODE_ATOL}, rtol {DECODE_RTOL}"
          + (f"; the forward's rounding response alone passes atol, so the "
             f"logits are held to {DECODE_RESP_FACTOR} x it"
             if conditioned else "") + f") [{card}]", flush=True)
    if not held or not max(blocks) <= DECODE_ATOL:
        raise AssertionError(f"decode {arch}: float32 decode differs from "
                             f"the forward (logits {gap}, over {over}, "
                             f"blocks {max(blocks)})")
    return {"f32_max_abs_err": gap, "f32_over": over,
            "f32_rounding_response": resp, "f32_conditioned": conditioned,
            "f32_block_overs": blocks}


def _decode_full_width(dev, card, arch, params, f32_check=True) -> tuple:
    """``launch.serve.generate`` on ``arch`` at full width on ``params``
    (the phase's last full-width run's): a warm call, then a timed one
    (ms a decode step p50 from CUDA events around each step, generated
    tokens a second over the call, synchronised at its end, peak memory);
    the timed call's tokens and last logits equal to the warm call's bit
    for bit; no kernel launch. With ``f32_check``, the 48 tokens in
    float32 against the forward (``_decode_f32``). -> (row, {path:
    launches})."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(arch)
    prompt = _decode_prompt(cfg, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    with _Steps() as warm:
        first = serve.generate(cfg, params, prompt, DECODE_GEN)
    torch.cuda.synchronize(dev)
    with _Steps(timed=True) as steps:
        t0 = time.perf_counter()
        out = serve.generate(cfg, params, prompt, DECODE_GEN)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = steps.step_ms()
    p50 = statistics.median(step_ms)
    tps = DECODE_BATCH * DECODE_GEN / wall
    same = torch.equal(out, first) and torch.equal(steps.last, warm.last)
    finite = bool(torch.isfinite(steps.last).all())
    aggs = sum(v for k, v in counts.items() if k.startswith("robust_agg"))
    print(f"[decode {arch}] full width, bfloat16, generate greedy at "
          f"batch {DECODE_BATCH}, prompt {DECODE_PROMPT}, gen "
          f"{DECODE_GEN}: ms per decode step p50 {p50:.3f} over "
          f"{len(step_ms)} steps (CUDA events around each step; min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}); {tps:.1f} "
          f"generated tokens/s (the timed call {wall * 1e3:.1f} ms, "
          f"synchronised); peak {peak / 2**30:.2f} GiB allocated; tokens "
          f"and last logits equal to the warm call's: {same}; robust_agg "
          f"launches {aggs}, all kernels {nonzero(counts)} [{card}]",
          flush=True)
    if not same or not finite:
        raise AssertionError(f"decode {arch}: the timed call does not "
                             f"repeat the warm one bit for bit (finite "
                             f"{finite})")
    if nonzero(counts):
        raise AssertionError(f"decode {arch}: serving launched "
                             f"{nonzero(counts)}")
    row = {"arch": arch, "batch": DECODE_BATCH, "prompt": DECODE_PROMPT,
           "gen": DECODE_GEN, "step_ms": step_ms, "ms_per_step_p50": p50,
           "tokens_per_s": tps, "wall_s": wall, "peak_bytes": peak,
           "repeat_bitwise": same}
    if f32_check:
        row.update(_decode_f32(cfg, params, torch.cat([prompt, out], dim=1),
                               arch, card))
    return row, {f"decode {arch}": {"launches": counts}}


def _decode(dev, card, arch, params, twin, f32_check=True) -> tuple:
    """The decode checks of one LM phase's model: full width on
    ``params``, and the reduced twin of ``twin``."""
    row, paths = _decode_full_width(dev, card, arch, params, f32_check)
    paths[f"decode {twin} reduced twin"] = _decode_twin(dev, card, twin)
    return row, paths


def _serve_cli(card) -> dict:
    """``launch.serve.main`` in process at its defaults (mamba2-130m at
    full width, on the card): tokens of the CLI's shape, no launch."""
    from repro_torch.launch import serve
    torch.cuda.empty_cache()
    reset_counts()
    res = serve.main([])
    counts = read_counts()
    print(f"[decode launch.serve] mamba2-130m in process: tokens "
          f"{tuple(res['tokens'].shape)}, steady {res['steady_s']:.3f} s, "
          f"{res['tokens_per_s']:.1f} tokens/s; launches {nonzero(counts)} "
          f"[{card}]", flush=True)
    if tuple(res["tokens"].shape) != (DECODE_BATCH, DECODE_GEN) or \
            nonzero(counts):
        raise AssertionError(f"launch.serve: tokens "
                             f"{tuple(res['tokens'].shape)}, launches "
                             f"{nonzero(counts)}")
    return {"launches": counts, "tokens_per_s": res["tokens_per_s"]}


# the chaos phase: ``launch.chaos.main(["--smoke"])`` in process on the
# card at the CLI's defaults (12 workers, 2 Byzantine, 2 faulty, 8
# rounds; cm and rfa x gspmd and pallas x nan_grad, stale_replay, and
# corrupt_wire on pallas alone)
CHAOS_CFG = dict(n_workers=12, n_byz=2, n_faulty=2, steps=8, seed=0)
CHAOS_LOG_EVERY = 2                # the smoke grid's
CHAOS_CELLS = [(kind, rule, backend)
               for kind in ("nan_grad", "stale_replay", "corrupt_wire")
               for rule in ("cm", "rfa") for backend in ("gspmd", "pallas")
               if kind != "corrupt_wire" or backend == "pallas"]
CHAOS_TOL = 2e-5                   # final loss, relative, card vs CPU


def _chaos_cpu(threads=None) -> dict:
    """Each smoke cell's ``run_cell`` on the CPU, and a MARINA cell's
    coins round by round (``log_every`` 1: the trajectory is the same)."""
    from repro_torch.api import run
    from repro_torch.launch import chaos
    if threads is not None:
        torch.set_num_threads(threads)
    out = {}
    for kind, rule, backend in CHAOS_CELLS:
        spec = chaos.cell_spec(rule, backend, kind, **CHAOS_CFG)
        cell = chaos.run_cell(spec, kind, log_every=CHAOS_LOG_EVERY,
                              device="cpu")
        if spec.method == "marina":
            cell["c_k"] = [int(h["c_k"]) for h in
                           run(spec, device="cpu", log_every=1).history]
        out[f"{kind} {rule} {backend}"] = cell
    return out


def chaos_counts(spec, ck) -> dict:
    """Launches of a chaos cell: none off pallas; on it, the warm-up's
    steps (an untraced one and, under the trace, a traced one: each round
    0 again) and every round, with every launch masked by the guard:
    sgd aggregates the packed b+w segment once a round, MARINA on the
    TopK wire as ``expected_counts`` (``ck``: its coins round by
    round)."""
    if spec.agg_mode != "pallas":
        return dict.fromkeys(COUNTED, 0)
    warm = 2 if spec.trace else 1
    if spec.method == "sgd":
        return zoo_counts(spec.aggregator, spec.steps + warm, guard=True)
    ck = list(ck) + [ck[0]] * warm
    return expected_counts(spec.aggregator, sum(ck), len(ck) - sum(ck),
                           guard=True)


def chaos_phase(dev, card) -> dict:
    """The port's chaos CLI on the card: ``--smoke`` exits 0 with a GREEN
    report and a verified stream; each cell's launches exact by
    ``chaos_counts``, the guard-off control's none; each cell held to the
    same cell on the CPU (final loss within CHAOS_TOL relative, finite,
    recall and precision equal)."""
    from repro_torch.api import RunSpec
    from repro_torch.launch import chaos
    t_phase = time.time()
    out_dir = ROOT / "build" / "chip_smoke_chaos"
    real_cell, real_run, got = chaos.run_cell, RunSpec.run, {}

    def counted_cell(spec, kind, **kw):
        res = {}

        def run(self, *a, **k):
            res["run"] = real_run(self, *a, **k)
            return res["run"]

        reset_counts()
        RunSpec.run = run
        try:
            cell = real_cell(spec, kind, **kw)
        finally:
            RunSpec.run = real_run
        got[f"{kind} {spec.aggregator} {spec.agg_mode}"] = (
            spec, cell, read_counts(), res["run"].history)
        return cell

    chaos.run_cell = counted_cell
    try:
        rc = chaos.main(["--smoke", "--out-dir", str(out_dir)])
    finally:
        chaos.run_cell = real_cell
    ctrl_counts = read_counts()          # the last cell's and the control's
    report = json.loads((out_dir / "fault_report.json").read_text())
    if rc != 0 or not report["green"]:
        raise AssertionError(f"chaos --smoke on the card: exit {rc}, "
                             f"green {report['green']}")
    if sorted(got) != sorted(f"{k} {r} {b}" for k, r, b in CHAOS_CELLS):
        raise AssertionError(f"chaos: cells {sorted(got)}")
    cpu = CPU_RUNS.result("chaos cpu", _chaos_cpu)
    paths, rows = {}, {}
    for tag, (spec, cell, counts, hist) in got.items():
        want_cell = cpu[tag]
        ck = want_cell.get("c_k")
        if ck is not None and [int(h["c_k"]) for h in hist] != [
                ck[h["step"]] for h in hist]:
            raise AssertionError(f"chaos {tag}: coins differ from the CPU")
        want = chaos_counts(spec, ck)
        a, b = cell["final_loss"], want_cell["final_loss"]
        rel = abs(a - b) / max(abs(b), 1e-12)
        same = all(cell[k] == want_cell[k] for k in
                   ("finite", "fault_recall", "fault_precision",
                    "rounds_traced"))
        print(f"[chaos {tag}] launches {nonzero(counts)} (expected "
              f"{nonzero(want)}); final loss {a:.6f} vs the CPU's {b:.6f} "
              f"(rel {rel:.3e}, limit {CHAOS_TOL}); recall "
              f"{cell['fault_recall']}, precision {cell['fault_precision']}"
              f", finite {cell['finite']}: equal to the CPU's {same} "
              f"[{card}]", flush=True)
        if counts != want:
            raise AssertionError(f"chaos {tag}: launches {nonzero(counts)}, "
                                 f"expected {nonzero(want)}")
        if not same or not rel <= CHAOS_TOL:
            raise AssertionError(f"chaos {tag}: differs from the CPU cell "
                                 f"({cell} vs {want_cell})")
        paths[f"chaos {tag}"] = {"launches": counts}
        rows[tag] = {**cell, "cpu_final_loss": b, "rel_loss_diff": rel}
    if ctrl_counts != got[next(reversed(got))][2]:
        raise AssertionError("chaos: the guard-off control launched "
                             f"{nonzero(ctrl_counts)}")
    if report["device"] != "cuda":
        raise AssertionError(f"chaos: ran on {report['device']}")
    phase_s = time.time() - t_phase
    print(f"[chaos] phase {phase_s:.1f} s: GREEN, {len(rows)} cells held "
          f"to the CPU, the control non-finite [{card}]", flush=True)
    return {"paths": paths, "cells": rows, "phase_s": phase_s,
            "control_guard_off_nonfinite":
            report["control_guard_off_nonfinite"]}


# the CPU checks' plain runs: CPU_POOL_WORKERS processes of
# CPU_POOL_THREADS threads each compute them while the card runs
CPU_POOL_WORKERS = 3
CPU_POOL_THREADS = 2


def _spec_key(spec) -> str:
    return json.dumps(spec, sort_keys=True, default=str)


def _cpu_history(spec, threads=None) -> list:
    """The history of ``api.run(spec)`` on the CPU."""
    from repro_torch.api import RunSpec, run
    if threads is not None:
        torch.set_num_threads(threads)
        share_cpu_data()
    return run(RunSpec(**spec), device="cpu", log_every=1).history


class _CpuRuns:
    """The plain CPU runs the checks compare the card with. Each depends
    on its spec alone (a worker's thread count can move a reduced LM
    twin's sums by an ulp, inside the checks' tolerances; never a coin),
    so a pool of worker processes computes those handed to ``start``
    while the card runs: the script's time is the card's, not the sum. A
    spec not handed over runs here when asked for."""

    def __init__(self):
        self.pool, self.futures = None, {}

    def start(self, specs, jobs=()):
        """Hand over the runs of ``specs``, and ``jobs``: (key, fn, args)
        whose ``fn(*args, threads)`` is a plain CPU check's result."""
        import concurrent.futures as cf
        import multiprocessing as mp
        self.pool = cf.ProcessPoolExecutor(
            CPU_POOL_WORKERS, mp_context=mp.get_context("spawn"))
        jobs = [(_spec_key(spec), _cpu_history, (spec,)) for spec in specs
                ] + list(jobs)
        for key, fn, args in jobs:
            if key not in self.futures:
                self.futures[key] = self.pool.submit(fn, *args,
                                                     CPU_POOL_THREADS)

    def result(self, key, fn, *args):
        """``fn(*args)``: the pool's result for ``key``, or run here."""
        fut = self.futures.pop(key, None)
        return fn(*args) if fut is None else fut.result()

    def history(self, spec) -> list:
        return self.result(_spec_key(spec), _cpu_history, spec)

    def close(self):
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None


CPU_RUNS = _CpuRuns()


def main_path_cases() -> list:
    """(tag, spec, launches(full, vr, rounds), options) of each main path
    of the whole run, in order."""
    cases = [(agg, {**MAIN_SPEC, "aggregator": agg},
              lambda f, v, r, a=agg: expected_counts(a, f, v), {})
             for agg in ("cm", "rfa", "krum")]
    cases += [(f"{agg} n=256", {**MAIN_SPEC, **GIANT_SPEC, "aggregator": agg},
               lambda f, v, r, a=agg: expected_counts(a, f, v, giant=True),
               {}) for agg in ("rfa", "krum")]
    cases.append(("byz_ef21 topk", dict(EF21_SPEC),
                  lambda f, v, r: ef21_counts(r), {}))
    cases += [(f"{agg} chaos", {**MAIN_SPEC, **CHAOS_SPEC, "aggregator": agg},
               lambda f, v, r, a=agg: expected_counts(a, f, v, guard=True),
               {}) for agg in ("cm", "rfa", "krum")]
    cases.append(("cm participation 0.8", {**MAIN_SPEC, **PART_SPEC},
                  lambda f, v, r: expected_counts("cm", f, v, cohort=True),
                  {}))
    cases += [(f"{agg} n=256 participation 0.75",
               {**MAIN_SPEC, **GIANT_PART_SPEC, "aggregator": agg},
               lambda f, v, r, a=agg: expected_counts(a, f, v, giant=True),
               {}) for agg in ("rfa", "krum")]
    quant = {"traj_tol": QUANT_TRAJ_TOL}
    cases += [(f"marina int8 {agg}", {**INT8_SPEC, "aggregator": agg},
               lambda f, v, r, a=agg: expected_counts(a, f, v, fmt="int8"),
               quant) for agg in ("cm", "rfa", "krum")]
    cases.append(("byz_ef21 sign", dict(SIGN_SPEC),
                  lambda f, v, r: ef21_counts(r, fmt="sign"), quant))
    cases.append(("byz_ef21 bf16", dict(BF16_SPEC),
                  lambda f, v, r: ef21_counts(r, fmt="bf16"), quant))
    # corrupt_wire flips 8-bit levels and float32 norms; the guard admits a
    # finite garbled norm by design, and with ALIE's statistics taking it
    # in the run diverges, in the reference as here
    cases.append(("marina int8 cm chaos", {**INT8_SPEC, **CHAOS_SPEC},
                  lambda f, v, r: expected_counts("cm", f, v, guard=True,
                                                  fmt="int8"),
                  {**quant, "diverges": True}))
    cases.append(("byz_ef21 bf16 krum chaos",
                  {**BF16_SPEC, **CHAOS_SPEC, "aggregator": "krum"},
                  lambda f, v, r: ef21_counts(r, fmt="bf16",
                                              aggregator="krum", guard=True),
                  quant))
    for tag, over, load in ZOO_PATHS:
        spec = {**MAIN_SPEC, **over}
        cases.append((tag, spec,
                      lambda f, v, r, a=spec["aggregator"], ld=load:
                      zoo_counts(a, r, ld), {}))
    cases.append(("marina RN cm", RN_SPEC,
                  lambda f, v, r: expected_counts("cm", f, v, dense_vr=True),
                  {"diverges": True}))
    return cases


def zoo_rest_specs() -> list:
    """The specs of ``zoo_obs_paths``' main paths, in its order."""
    return [SPARSE_SPEC] + [{**MAIN_SPEC, **over}
                            for _, over in ZOO_REST_PATHS]


def share_cpu_data():
    """The paths' CPU checks build the same few datasets (a9a width at 5
    and 256 workers, gisette width) again for every path, some 2.4 s of
    threefry a9a build on a CPU: build each once. Runs on the card build
    their own."""
    import repro_torch.data as D
    make, cache = D.make_logreg_data, {}
    if getattr(make, "shared", False):
        return

    def cached(key, **kw):
        if key.device.type != "cpu":
            return make(key, **kw)
        k = (tuple(key.tolist()), tuple(sorted(kw.items())))
        if k not in cache:
            cache[k] = make(key, **kw)
        return cache[k]

    cached.shared = True
    D.make_logreg_data = cached


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", choices=("all", "kernels", "tracer",
                                         "zoo_obs", "exec", "serve", "chaos",
                                         "lm", "lm_moe", "lm_ssm"),
                    default="all",
                    help="'kernels': the kernel phases alone (no paths, "
                         "no kernels line), e.g. to time another tree's "
                         "kernels with this script's measurements; "
                         "'tracer': the profiler's lost events and clock "
                         "offset alone (no build); 'zoo_obs': the build and "
                         "the paths of sparse support, the dense "
                         "compressors, importance sampling and tracing "
                         "alone (no kernels line); 'exec': the build and "
                         "the checkpoint, resume, warm-up, worker-pool "
                         "sweep and seed-group checks alone (no kernels "
                         "line); 'serve': the build and the streaming "
                         "service's phase alone (no kernels line); 'chaos': "
                         "the build and the chaos CLI's phase alone (no "
                         "kernels line); 'lm': the build and the LM phase "
                         "alone, its decode included (no kernels line); "
                         "'lm_moe': the build and the MLA and MoE phase "
                         "alone (no kernels line); 'lm_ssm': the build and "
                         "the SSD and RG-LRU phase alone (no kernels line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    print(f"[card] {card}", flush=True)
    if args.phases == "tracer":
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_tracer.json").write_text(
            json.dumps({"card": card, **tracer_probe(dev, card)}))
        return 0
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    for name, log in _build.build().items():
        print(f"[build] {name}.cu ({time.time() - t0:.1f} s):\n{log.strip()}",
              flush=True)
    print(f"[build] every kernel built in {time.time() - t0:.1f} s",
          flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    share_cpu_data()
    if args.phases == "zoo_obs":
        got = zoo_obs_paths(dev, card)
        (out_dir / "chip_smoke_zoo_obs.json").write_text(json.dumps(
            {"card": card, "torch": torch.__version__, **got,
             "wall_s": time.time() - t_start}, indent=1, default=str))
        print(f"[done] the zoo_obs paths alone, "
              f"{time.time() - t_start:.1f} s", flush=True)
        return 0
    if args.phases in ("serve", "chaos"):
        got = {"serve": serve_phase,
               "chaos": chaos_phase}[args.phases](dev, card)
        (out_dir / f"chip_smoke_{args.phases}.json").write_text(json.dumps(
            {"card": card, "torch": torch.__version__, **got,
             "wall_s": time.time() - t_start}, indent=1, default=str))
        print(f"[done] the {args.phases} phase alone, "
              f"{time.time() - t_start:.1f} s", flush=True)
        return 0
    if args.phases in ("lm", "lm_moe", "lm_ssm"):
        got = {"lm": lm_phase, "lm_moe": lm_moe_phase,
               "lm_ssm": lm_ssm_phase}[args.phases](dev, card)
        (out_dir / f"chip_smoke_{args.phases}.json").write_text(json.dumps(
            {"card": card, "torch": torch.__version__, **got,
             "wall_s": time.time() - t_start}, indent=1, default=str))
        print(f"[done] the {args.phases} phase alone, "
              f"{time.time() - t_start:.1f} s", flush=True)
        print(gpu_line(), flush=True)
        return 0
    if args.phases == "exec":
        got = exec_phase(dev, card)
        (out_dir / "chip_smoke_exec.json").write_text(json.dumps(
            {"card": card, "torch": torch.__version__, **got,
             "wall_s": time.time() - t_start}, indent=1, default=str))
        print(f"[done] the exec phase alone, {time.time() - t_start:.1f} s",
              flush=True)
        return 0
    marks = {}

    def mark(what):
        marks[what] = time.time() - t_start
        print(f"[phase] {what} at {marks[what]:.1f} s", flush=True)

    mark("build done")
    path_cases = main_path_cases()
    if args.phases == "all":
        CPU_RUNS.start([{**spec, "steps": CPU_CHECK_STEPS}
                        for _, spec, _, _ in path_cases]
                       + [{**spec, "steps": CPU_CHECK_STEPS}
                          for spec in zoo_rest_specs()]
                       + [{**_twin_spec(arch), "steps": LM_TWIN_STEPS}
                          for arch in ("qwen3-1.7b",) + LM_MOE_TWINS
                          + LM_SSM_TWINS],
                       [("chaos cpu", _chaos_cpu, ())]
                       + [(f"decode {arch}", _decode_twin_run, (arch, "cpu"))
                          for arch in DECODE_TWINS])
    main_rows = [kernel_case(c, dev) for c in MAIN_CASES]
    wide_rows = [kernel_case(c, dev) for c in WIDE_CASES]
    norm_main = [r for c in NORM_MAIN_CASES for r in norm_case(c, dev)]
    norm_wide = [r for c in NORM_WIDE_CASES for r in norm_case(c, dev)]
    blocked_main = [r for c in BLOCKED_MAIN_CASES
                    for r in blocked_case(c, dev, card)]
    blocked_wide = [r for c in BLOCKED_WIDE_CASES
                    for r in blocked_case(c, dev, card)]
    topk_main = [topk_case(c, dev, card) for c in TOPK_MAIN_CASES]
    topk_wide = [topk_case(c, dev, card) for c in TOPK_WIDE_CASES]
    masked_main = [kernel_case(c, dev) for c in MASKED_MAIN_CASES]
    masked_wide = [kernel_case(c, dev) for c in MASKED_WIDE_CASES]
    norm_masked_main = [r for c in MASKED_MAIN_CASES
                        for r in norm_case(c[:7] + c[8:], dev)]
    norm_masked_wide = [r for c in MASKED_WIDE_CASES
                        for r in norm_case(c[:7] + c[8:], dev)]
    load_main = [kernel_case(c, dev) for c in LOAD_MAIN_CASES]
    load_wide = [kernel_case(c, dev)
                 for c in LOAD_WIDE_CASES + [LOAD_BF16_STACK_CASE]]
    load_norm_main = [r for c in LOAD_MAIN_CASES
                      for r in norm_case(c[:7], dev)]
    load_norm_wide = [r for c in LOAD_WIDE_CASES
                      for r in norm_case(c[:7], dev)]
    load_masked_main = [kernel_case(c, dev) for c in LOAD_MASKED_MAIN_CASES]
    load_masked_wide = [kernel_case(c, dev) for c in LOAD_MASKED_WIDE_CASES]
    load_norm_masked_main = [r for c in LOAD_MASKED_MAIN_CASES
                             for r in norm_case(c[:7] + c[8:], dev)]
    load_norm_masked_wide = [r for c in LOAD_MASKED_WIDE_CASES
                             for r in norm_case(c[:7] + c[8:], dev)]
    cases = {"main_cases": main_rows, "wide_cases": wide_rows,
             "norm_main_cases": norm_main, "norm_wide_cases": norm_wide,
             "blocked_main_cases": blocked_main,
             "blocked_wide_cases": blocked_wide,
             "topk_main_cases": topk_main, "topk_wide_cases": topk_wide,
             "masked_main_cases": masked_main,
             "masked_wide_cases": masked_wide,
             "norm_masked_main_cases": norm_masked_main,
             "norm_masked_wide_cases": norm_masked_wide,
             "load_main_cases": load_main, "load_wide_cases": load_wide,
             "load_norm_main_cases": load_norm_main,
             "load_norm_wide_cases": load_norm_wide,
             "load_masked_main_cases": load_masked_main,
             "load_masked_wide_cases": load_masked_wide,
             "load_norm_masked_main_cases": load_norm_masked_main,
             "load_norm_masked_wide_cases": load_norm_masked_wide}
    mark("kernel cases done")
    quant = ops_path(dev, card)
    cases["block_quantize_cases"] = quant["cases"]
    if args.phases == "kernels":
        (out_dir / "chip_smoke_kernels.json").write_text(json.dumps(
            {"card": card, "torch": torch.__version__,
             "cuda": torch.version.cuda, **cases,
             "wall_s": time.time() - t_start}, indent=1))
        print(f"[done] kernel phases alone, {time.time() - t_start:.1f} s",
              flush=True)
        return 0
    check_lean(cases)
    mark("ops path done")
    cases["sparse_bounds_cases"] = [bounds_case(c, dev)
                                    for c in BOUNDS_CASES]
    paths = {tag: main_path(dev, card, tag, spec, want, **kw)
             for tag, spec, want, kw in path_cases}
    paths["ops.block_quantize"] = {"launches": quant["launches"]}
    paths["ops wire"] = ops_wire_path(dev, card)
    mark("main paths done")
    zoo_obs = zoo_obs_paths(dev, card)
    mark("zoo_obs paths done")
    paths.update(zoo_obs["paths"])
    paths.update({f"traced {tag}": {"launches": row["launches"]}
                  for tag, row in zoo_obs["traced"].items()})
    exec_got = exec_phase(dev, card)
    paths.update(exec_got["paths"])
    mark("exec phase done")
    serve_got = serve_phase(dev, card)
    paths.update(serve_got["paths"])
    mark("serve phase done")
    chaos_got = chaos_phase(dev, card)
    paths.update(chaos_got["paths"])
    mark("chaos phase done")
    lm_got = lm_phase(dev, card)
    paths.update(lm_got["paths"])
    mark("lm phase done")
    moe_got = lm_moe_phase(dev, card)
    paths.update(moe_got["paths"])
    mark("lm_moe phase done")
    ssm_got = lm_ssm_phase(dev, card)
    paths.update(ssm_got["paths"])
    mark("lm_ssm phase done")
    path_specs = {"cm": MAIN_SPEC, "rfa": {**MAIN_SPEC, "aggregator": "rfa"},
                  "krum": {**MAIN_SPEC, "aggregator": "krum"},
                  "cm chaos": {**MAIN_SPEC, **CHAOS_SPEC},
                  "byz_ef21 topk": EF21_SPEC}
    profiles = [path_profile(dev, card, tag, path_specs[tag])
                for tag in PROFILED_PATHS]

    def launches(*keys):
        return sum(p["launches"][k] for p in paths.values() for k in keys)

    kernels = []
    for kind, load in (("dense", "dense"), ("sparse_wire", "sparse")):
        kernels.append(kernel_entry(
            f"robust_agg ({kind} load)",
            "src/repro_torch/kernels/csrc/robust_agg.cu", REPLACES[kind],
            launches(f"robust_agg/{load}"),
            [r for r in main_rows if r["kind"] == kind]))
    for kind, load in (("dense", "dense"), ("sparse_wire", "sparse")):
        kernels.append(kernel_entry(
            f"robust_agg ({kind} load, masked)",
            "src/repro_torch/kernels/csrc/robust_agg.cu",
            REPLACES["masked" if kind == "dense" else kind],
            launches(f"robust_agg/{load} masked"),
            [r for r in masked_main if r["kind"] == kind]))
    for name in NORM_KERNELS:
        kernels.append(kernel_entry(
            name, "src/repro_torch/kernels/csrc/norm_agg.cu",
            REPLACES[name], launches(f"{name}/dense", f"{name}/sparse"),
            [r for r in norm_main if r["kernel"] == name]))
        kernels.append(kernel_entry(
            f"{name} (masked load)",
            "src/repro_torch/kernels/csrc/norm_agg.cu", REPLACES[name],
            launches(f"{name}/dense masked", f"{name}/sparse masked"),
            [r for r in norm_masked_main if r["kernel"] == name]))
    # this slice's loads: a row for each fused kernel and load that a path
    # launched, masked apart; every (kernel, load) pair, masked or not, is
    # held to its plain version above whether a path reaches it or not
    for load in NEW_LOADS:
        for name in FUSED_KERNELS:
            for tag, rows in (("", load_main + load_norm_main),
                              (" masked", load_masked_main
                               + load_norm_masked_main)):
                n_launch = launches(f"{name}/{load}{tag}")
                if not n_launch:
                    continue
                # the LM paths' leaves are its rows too
                lm_rows = (lm_got["kernel_rows"][1:]
                           + moe_got["kernel_rows"]
                           + ssm_got["kernel_rows"]
                           if (name, load, tag) == ("robust_agg",
                                                    "dense_bf16", "")
                           else [])
                src = ("robust_agg.cu" if name == "robust_agg"
                       else "norm_agg.cu")
                kernels.append(kernel_entry(
                    f"{name} ({load} load{',' if tag else ''}{tag})",
                    f"src/repro_torch/kernels/csrc/{src}", REPLACES[load],
                    n_launch, [r for r in rows if r["kind"] == load
                               and r["kernel"] == name] + lm_rows))
    for name in BLOCKED_KERNELS:
        kernels.append(kernel_entry(
            name, "src/repro_torch/kernels/csrc/norm_agg_blocked.cu",
            REPLACES[name], launches(name),
            [r for r in blocked_main if r["kernel"] == name]))
    kernels.append(kernel_entry(
        "topk_select", "src/repro_torch/kernels/csrc/topk_select.cu",
        REPLACES["topk_select"], launches("topk_select"), topk_main))
    kernels.append(kernel_entry(
        "block_quantize", "src/repro_torch/kernels/csrc/block_quantize.cu",
        REPLACES["block_quantize"], launches("block_quantize"),
        quant["cases"]))
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         **cases,
         "main_paths": paths, "traced_paths": zoo_obs["traced"],
         "profile_trace": zoo_obs["profile_trace"], "path_profiles": profiles,
         "exec": {k: v for k, v in exec_got.items() if k != "paths"},
         "serve": {k: v for k, v in serve_got.items() if k != "paths"},
         "chaos": {k: v for k, v in chaos_got.items() if k != "paths"},
         "lm": {k: v for k, v in lm_got.items() if k != "paths"},
         "lm_moe": {k: v for k, v in moe_got.items() if k != "paths"},
         "lm_ssm": {k: v for k, v in ssm_got.items() if k != "paths"},
         "phase_marks_s": marks,
         "no_library": NO_LIBRARY, "kernels": kernels,
         "wall_s": time.time() - t_start}, indent=1))
    print(f"[done] {time.time() - t_start:.1f} s in all", flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        CPU_RUNS.close()
