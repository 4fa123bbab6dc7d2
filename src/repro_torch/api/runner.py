"""Build and run experiments from a ``RunSpec`` (port of
``repro/api/runner.py``).

The key schedule is the reference's, so a trajectory is the same pure
function of the spec in both packages:

    k_init, k_run = split(PRNGKey(spec.seed))
    params        = init_params(k_init)
    state         = method.init(params, anchor(0), k_run)
    per round it:   k_step, k_batch = split(fold_in(k_run, it + 1))
                    state, metrics = step(state, minibatch(it, k_batch),
                                          anchor(it), k_step)

Everything runs on one device: the card unless the caller passes
``device="cpu"``. Under ``spec.trace`` the logged rounds run the
telemetry twin (``Method.step_traced``, the same trajectory bit for bit)
and record their ``RoundTrace``; ``sink=`` / ``metrics_jsonl=`` stream
the round, trace, span and gauge events. Checkpoints, callbacks and the
warm-up step are not ported yet (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import random as R
from repro_torch.core import tree_utils as tu
from repro_torch.core.engine import Method, make_method


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA where there is none raises:
    no entry point moves to the CPU unless the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return device


@dataclasses.dataclass
class Experiment:
    """The method plus its data plumbing; ``minibatch(it, key)`` and
    ``anchor(it)`` return stacked (n, ...) batches on ``device``."""
    spec: Any
    cfg: Any
    method: Method
    loss_fn: Callable
    corrupt_fn: Optional[Callable]
    init_params: Callable                # key -> params
    minibatch: Callable
    anchor: Callable
    device: torch.device
    data: Any = None


def build(spec, device=None) -> Experiment:
    """Assemble (method, data, loss, corrupt_fn) for ``spec``."""
    from repro_torch.data import (corrupt_labels_logreg, init_logreg_params,
                                  logreg_loss, make_logreg_data)
    device = resolve_device(device)
    cfg = spec.build_config()
    dk = spec.data_kwargs
    dim = int(dk.get("dim", 30))
    lam = float(dk.get("lam", 0.01))
    batch_size = int(dk.get("batch_size", 32))
    data = make_logreg_data(
        R.PRNGKey(int(dk.get("data_seed", 0)), device=device),
        n_samples=int(dk.get("n_samples", 400)), dim=dim,
        n_workers=spec.n_workers,
        homogeneous=bool(dk.get("homogeneous", True)),
        noise=float(dk.get("noise", 0.1)))
    loss = logreg_loss(lam, nonconvex=bool(dk.get("nonconvex", False)))
    anchor = data.stacked()
    if dk.get("sampling", "uniform") == "importance":
        from repro_torch.core.theory import importance_weights
        probs, _ = importance_weights(data.features, lam)

        def minibatch(it, key):
            return data.sample_batches_importance(key, batch_size, probs)
    else:
        def minibatch(it, key):
            return data.sample_batches(key, batch_size)
    return Experiment(
        spec=spec, cfg=cfg,
        method=make_method(spec.method, cfg, loss, corrupt_labels_logreg,
                           **spec.method_kwargs),
        loss_fn=loss, corrupt_fn=corrupt_labels_logreg,
        init_params=lambda key: init_logreg_params(dim, device=device),
        minibatch=minibatch,
        anchor=lambda it: anchor, device=device, data=data)


@dataclasses.dataclass
class RunResult:
    spec: Any
    history: list                        # logged metric dicts
    state: dict                          # final engine state
    n_params: int
    comm_bits: float                     # total uploaded bits per worker
    wall_s: float

    @property
    def params(self):
        return self.state["params"]

    traces: list = dataclasses.field(default_factory=list)
    # host RoundTrace dicts, one per logged step (spec.trace runs only)

    @property
    def final(self) -> dict:
        return self.history[-1] if self.history else {}

    def detection_summary(self, frac: float = 0.5) -> dict:
        """Mean filter precision / recall and byzantine influence leakage
        over the logged traces ({} without spec.trace)."""
        from repro_torch.obs import detect
        return detect.summarize(self.traces, frac)


def _trace_metrics(trace_host: dict) -> dict:
    """A logged round's detection metrics from its host trace, and the
    guard's against the injected faults on chaos rounds."""
    from repro_torch.obs import detect
    det = detect.detection_metrics(trace_host)
    m = {"detect_precision": det["precision"],
         "detect_recall": det["recall"],
         "byz_leakage": det["byz_leakage"],
         "n_filtered": det["n_filtered"]}
    fm = detect.fault_metrics(trace_host)
    if fm:
        m.update(fault_precision=fm["fault_precision"],
                 fault_recall=fm["fault_recall"],
                 n_fault_rejected=fm["n_rejected"])
    return m


def run(spec, device=None, *, log_every: int = 10, verbose: bool = False,
        sink=None, metrics_jsonl: Optional[str] = None) -> RunResult:
    """``build(spec, device)`` and the canonical loop (module docstring).
    Every ``log_every``-th step and the last one are recorded; under
    ``spec.trace`` those, and only those, run the telemetry twin.

    ``sink`` (an ``obs.sink.MetricSink``) receives a ``{"type":
    "round"}`` event per logged round, a ``{"type": "trace"}`` event per
    traced one, then a ``{"type": "span", "name": "run"}`` event and, with
    traces, a ``{"type": "gauge", "name": "detection_summary"}``.
    ``metrics_jsonl`` is a path: a ``JsonlSink`` there, fanned out with
    ``sink``."""
    from repro_torch.obs.profile import round_range
    own_jsonl = None
    if metrics_jsonl:
        from repro_torch.obs.sink import FanoutSink, JsonlSink
        own_jsonl = JsonlSink(metrics_jsonl)
        sink = FanoutSink(sink, own_jsonl) if sink is not None else own_jsonl
    exp = build(spec, device)
    key = R.PRNGKey(spec.seed, device=exp.device)
    k_init, k_run = R.split(key)
    params = exp.init_params(k_init)
    n_params = int(tu.tree_size(params))
    state = exp.method.init(params, exp.anchor(0), k_run)
    history, traces = [], []
    comm_bits = 0.0
    # under partial participation only the sampled cohort uploads: each
    # round is billed at n_active / n_workers of its bits, the measured
    # twin of theory.comm_bits_per_round(..., participation=...)
    part_frac = spec.resolved_participation() / spec.n_workers
    t0 = time.time()
    for it in range(spec.steps):
        do_log = it % max(log_every, 1) == 0 or it == spec.steps - 1
        # the telemetry twin at log cadence only: the same trajectory, and
        # the rounds in between stay the untraced step
        step = (exp.method.step_traced if spec.trace and do_log
                else exp.method.step)
        with round_range():
            k_step, k_batch = R.split(R.fold_in(k_run, it + 1))
            state, metrics = step(state, exp.minibatch(it, k_batch),
                                  exp.anchor(it), k_step)
        rt = metrics.pop("trace", None)
        comm_bits += part_frac * exp.method.round_bits(
            n_params, bool(metrics.get("c_k", 1)))
        if do_log:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=it, wall_s=round(time.time() - t0, 2),
                     comm_bits=comm_bits,
                     comm_gbits=round(comm_bits / 1e9, 4))
            trace_host = None
            if rt is not None:
                from repro_torch.obs.trace import to_host
                trace_host = to_host(rt)
                m.update(_trace_metrics(trace_host))
                traces.append(trace_host)
            history.append(m)
            if sink is not None:
                sink.emit({"type": "round", **m})
                if trace_host is not None:
                    sink.emit({"type": "trace", "step": it, **trace_host})
            if verbose:
                print(f"  step {it:5d} loss {m['loss']:.4f} "
                      f"|g| {m['g_norm']:.3e} c_k={int(m.get('c_k', 1))} "
                      f"comm {m['comm_gbits']:.3g}Gb ({m['wall_s']}s)")
    if exp.device.type == "cuda":
        torch.cuda.synchronize(exp.device)
    result = RunResult(spec=spec, history=history, state=state,
                       n_params=n_params, comm_bits=comm_bits,
                       wall_s=time.time() - t0, traces=traces)
    if sink is not None:
        sink.emit({"type": "span", "name": "run",
                   "wall_s": round(result.wall_s, 6), "steps": spec.steps})
        if traces:
            sink.emit({"type": "gauge", "name": "detection_summary",
                       "value": result.detection_summary()})
        if own_jsonl is not None:
            own_jsonl.close()
    return result
