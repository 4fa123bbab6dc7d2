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
the round, trace, span and gauge events. ``checkpoint=`` saves the full
engine state and ``resume=`` restarts from it on the same key schedule,
so an interrupted and resumed run is the uninterrupted one bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
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
    data: Any = None                     # LogRegData (logreg task)
    arch_cfg: Any = None                 # ArchConfig (lm task)

    def run(self, **run_kw) -> "RunResult":
        return _run_experiment(self, **run_kw)


def build(spec, device=None) -> Experiment:
    """Assemble (method, data, loss, corrupt_fn) for ``spec``."""
    device = resolve_device(device)
    cfg = spec.build_config()
    builder = _build_logreg if spec.task == "logreg" else _build_lm
    return builder(spec, cfg, device)


def _build_logreg(spec, cfg, device) -> Experiment:
    from repro_torch.data import (corrupt_labels_logreg, init_logreg_params,
                                  logreg_loss, make_logreg_data)
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


def _build_lm(spec, cfg, device) -> Experiment:
    """The LM task: a registered ``ArchConfig`` (``reduced()`` under
    ``data_kwargs["reduced"]``), its ``TokenStream`` on ``device``, and
    the model's sequence-chunked cross entropy over the flat parameter
    dict. Tokens do not depend on the round key."""
    from repro_torch.api import registry
    from repro_torch.data import TokenStream, corrupt_labels_lm
    from repro_torch.models import init_params as model_init
    from repro_torch.models import loss_fn as model_loss
    dk = spec.data_kwargs
    acfg = registry.resolve("arch", spec.arch)
    if dk.get("reduced", False):
        acfg = acfg.reduced()
    stream = TokenStream(
        vocab_size=acfg.vocab_size, seq_len=int(dk.get("seq_len", 128)),
        n_workers=spec.n_workers,
        per_worker_batch=int(dk.get("per_worker_batch", 4)),
        num_codebooks=acfg.num_codebooks,
        frontend_tokens=acfg.frontend_tokens, d_model=acfg.d_model,
        heterogeneous=bool(dk.get("heterogeneous", False)), seed=spec.seed,
        device=device)
    remat = bool(dk.get("remat", False))

    def loss(params, batch, key):
        return model_loss(params, acfg, batch, remat=remat)

    # one worker's activations at a time (engine.worker_vmap): at full
    # width n workers' would not fit beside the gradient stacks
    loss.worker_chunk = 1
    return Experiment(
        spec=spec, cfg=cfg,
        method=make_method(spec.method, cfg, loss, corrupt_labels_lm,
                           **spec.method_kwargs),
        loss_fn=loss, corrupt_fn=corrupt_labels_lm,
        init_params=lambda key: model_init(key, acfg),
        minibatch=lambda it, key: stream.minibatch(it),
        anchor=stream.anchor, device=device, arch_cfg=acfg)


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

    def to_dict(self) -> dict:
        """Artifact payload: the resolved spec beside the trajectory, so a
        result file alone reproduces the run."""
        out = {"spec": self.spec.to_dict(), "n_params": self.n_params,
               "comm_bits": self.comm_bits, "wall_s": self.wall_s,
               "history": self.history}
        if self.traces:
            out["detection"] = self.detection_summary()
        return out


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


def run(spec, device=None, **run_kw) -> RunResult:
    """``build(spec, device)`` and the canonical loop (module docstring).
    The keyword options are the reference's loop knobs:

      log_every    — record (and with verbose=True, print) every k-th step
                     and the last one; under ``spec.trace`` those, and
                     only those (and callback steps), run the telemetry
                     twin.
      verbose      — print per-log-step progress lines.
      warmup       — run one throwaway step first (the traced twin's too
                     under ``spec.trace``) so ``wall_s`` is steady state;
                     the trajectory is unchanged.
      checkpoint   — path prefix: save the FULL engine state (params,
                     estimator state, step) through ``repro_torch
                     .checkpoint`` at the end of the run and every
                     ``checkpoint_every`` steps.
      checkpoint_every — periodic checkpoint cadence in steps (needs
                     ``checkpoint``); the crash-restart point.
      resume       — checkpoint prefix to restart from: the state is
                     restored and the loop goes on at the saved step with
                     the same key schedule, so the resumed run reproduces
                     the uninterrupted trajectory bit for bit.
                     (``history`` and ``comm_bits`` restart at the resume
                     point: they cover the resumed segment only.)
      metrics_out  — path: dump ``RunResult.to_dict()`` as JSON.
      callback     — fn(it, state, logged_metrics); a truthy return stops
                     the run early, and the stop point is recorded.
      callback_every — callback cadence in steps (default: the log
                     steps). Metrics are read to the host only on log and
                     callback steps.
      sink         — an ``obs.sink.MetricSink``: a ``{"type": "round"}``
                     event per logged round, a ``{"type": "trace"}`` event
                     per traced one, then a ``{"type": "span", "name":
                     "run"}`` event and, with traces, a ``{"type":
                     "gauge", "name": "detection_summary"}``.
      metrics_jsonl — path: a ``JsonlSink`` there, fanned out with
                     ``sink``.
    """
    return _run_experiment(build(spec, device), **run_kw)


def _run_experiment(exp: Experiment, *, log_every: int = 10,
                    verbose: bool = False, warmup: bool = False,
                    checkpoint: Optional[str] = None,
                    checkpoint_every: Optional[int] = None,
                    resume: Optional[str] = None,
                    metrics_out: Optional[str] = None,
                    callback: Optional[Callable] = None,
                    callback_every: Optional[int] = None,
                    sink=None,
                    metrics_jsonl: Optional[str] = None) -> RunResult:
    from repro_torch.obs.profile import round_range
    spec = exp.spec
    own_jsonl = None
    if metrics_jsonl:
        from repro_torch.obs.sink import FanoutSink, JsonlSink
        own_jsonl = JsonlSink(metrics_jsonl)
        sink = FanoutSink(sink, own_jsonl) if sink is not None else own_jsonl
    key = R.PRNGKey(spec.seed, device=exp.device)
    k_init, k_run = R.split(key)
    params = exp.init_params(k_init)
    n_params = int(tu.tree_size(params))
    state = exp.method.init(params, exp.anchor(0), k_run)
    start = 0
    if resume:
        from repro_torch.checkpoint import load_checkpoint
        state, ck_step = load_checkpoint(resume, like=state)
        start = int(ck_step or 0)
        if verbose:
            print(f"[run] resumed from {resume}.npz at step {start}")
    if warmup and spec.steps > 0:
        k_step, k_batch = R.split(R.fold_in(k_run, 1))
        wargs = (state, exp.minibatch(0, k_batch), exp.anchor(0), k_step)
        exp.method.step(*wargs)
        if spec.trace:
            exp.method.step_traced(*wargs)
        _sync(exp.device)
        del wargs
    if checkpoint:
        from repro_torch.checkpoint import save_checkpoint
    history, traces = [], []
    comm_bits = 0.0
    # under partial participation only the sampled cohort uploads: each
    # round is billed at n_active / n_workers of its bits, the measured
    # twin of theory.comm_bits_per_round(..., participation=...)
    part_frac = spec.resolved_participation() / spec.n_workers
    t0 = time.time()
    for it in range(start, spec.steps):
        last = it == spec.steps - 1
        do_log = it % max(log_every, 1) == 0 or last
        do_cb = callback is not None and (
            (it + 1) % max(callback_every, 1) == 0 or last
            if callback_every is not None else do_log)
        # the telemetry twin on log and callback steps only: the same
        # trajectory, and the rounds in between stay the untraced step
        step = (exp.method.step_traced if spec.trace and (do_log or do_cb)
                else exp.method.step)
        with round_range():
            k_step, k_batch = R.split(R.fold_in(k_run, it + 1))
            state, metrics = step(state, exp.minibatch(it, k_batch),
                                  exp.anchor(it), k_step)
        rt = metrics.pop("trace", None)
        comm_bits += part_frac * exp.method.round_bits(
            n_params, bool(metrics.get("c_k", 1)))
        if do_log or do_cb:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=it, wall_s=round(time.time() - t0, 2),
                     comm_bits=comm_bits,
                     comm_gbits=round(comm_bits / 1e9, 4))
            trace_host = None
            if rt is not None:
                from repro_torch.obs.trace import to_host
                trace_host = to_host(rt)
                m.update(_trace_metrics(trace_host))
            if do_log:
                history.append(m)
                if trace_host is not None:
                    traces.append(trace_host)
                if sink is not None:
                    sink.emit({"type": "round", **m})
                    if trace_host is not None:
                        sink.emit({"type": "trace", "step": it,
                                   **trace_host})
                if verbose:
                    print(f"  step {it:5d} loss {m['loss']:.4f} "
                          f"|g| {m['g_norm']:.3e} "
                          f"c_k={int(m.get('c_k', 1))} "
                          f"comm {m['comm_gbits']:.3g}Gb ({m['wall_s']}s)")
            if do_cb and callback(it, state, m):
                if not do_log:           # record the stop point
                    history.append(m)
                break
        if (checkpoint and checkpoint_every
                and (it + 1) % checkpoint_every == 0 and not last):
            save_checkpoint(checkpoint, state, step=state["step"])
            if verbose:
                print(f"[run] checkpoint @ step {it + 1} -> "
                      f"{checkpoint}.npz")
    _sync(exp.device)
    result = RunResult(spec=spec, history=history, state=state,
                       n_params=n_params, comm_bits=comm_bits,
                       wall_s=time.time() - t0, traces=traces)
    if sink is not None:
        sink.emit({"type": "span", "name": "run",
                   "wall_s": round(result.wall_s, 6),
                   "steps": spec.steps - start})
        if traces:
            sink.emit({"type": "gauge", "name": "detection_summary",
                       "value": result.detection_summary()})
        if own_jsonl is not None:
            own_jsonl.close()
    if checkpoint:
        # the FULL engine state, so a later run(..., resume=checkpoint)
        # restarts the exact trajectory
        save_checkpoint(checkpoint, state, step=state["step"])
        if verbose:
            print(f"[run] checkpoint -> {checkpoint}.npz")
    if metrics_out:
        with open(metrics_out, "w") as f:
            json.dump(result.to_dict(), f, indent=1)
    return result


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
