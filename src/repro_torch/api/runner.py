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
``device="cpu"``. Checkpoints, sinks, callbacks and the telemetry twin are
not ported yet (ROADMAP queue 1, items 8 and 9).
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
    if dk.get("sampling", "uniform") != "uniform":
        raise NotImplementedError(
            "importance sampling is not ported yet (ROADMAP queue 1, item 6b)")
    dim = int(dk.get("dim", 30))
    batch_size = int(dk.get("batch_size", 32))
    data = make_logreg_data(
        R.PRNGKey(int(dk.get("data_seed", 0)), device=device),
        n_samples=int(dk.get("n_samples", 400)), dim=dim,
        n_workers=spec.n_workers,
        homogeneous=bool(dk.get("homogeneous", True)),
        noise=float(dk.get("noise", 0.1)))
    loss = logreg_loss(float(dk.get("lam", 0.01)),
                       nonconvex=bool(dk.get("nonconvex", False)))
    anchor = data.stacked()
    return Experiment(
        spec=spec, cfg=cfg,
        method=make_method(spec.method, cfg, loss, corrupt_labels_logreg,
                           **spec.method_kwargs),
        loss_fn=loss, corrupt_fn=corrupt_labels_logreg,
        init_params=lambda key: init_logreg_params(dim, device=device),
        minibatch=lambda it, key: data.sample_batches(key, batch_size),
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

    @property
    def final(self) -> dict:
        return self.history[-1] if self.history else {}


def run(spec, device=None, *, log_every: int = 10,
        verbose: bool = False) -> RunResult:
    """``build(spec, device)`` and the canonical loop (module docstring).
    Every ``log_every``-th step and the last one are recorded."""
    exp = build(spec, device)
    key = R.PRNGKey(spec.seed, device=exp.device)
    k_init, k_run = R.split(key)
    params = exp.init_params(k_init)
    n_params = int(tu.tree_size(params))
    state = exp.method.init(params, exp.anchor(0), k_run)
    history = []
    comm_bits = 0.0
    # under partial participation only the sampled cohort uploads: each
    # round is billed at n_active / n_workers of its bits, the measured
    # twin of theory.comm_bits_per_round(..., participation=...)
    part_frac = spec.resolved_participation() / spec.n_workers
    t0 = time.time()
    for it in range(spec.steps):
        k_step, k_batch = R.split(R.fold_in(k_run, it + 1))
        state, metrics = exp.method.step(state, exp.minibatch(it, k_batch),
                                         exp.anchor(it), k_step)
        comm_bits += part_frac * exp.method.round_bits(
            n_params, bool(metrics.get("c_k", 1)))
        if it % max(log_every, 1) == 0 or it == spec.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=it, wall_s=round(time.time() - t0, 2),
                     comm_bits=comm_bits,
                     comm_gbits=round(comm_bits / 1e9, 4))
            history.append(m)
            if verbose:
                print(f"  step {it:5d} loss {m['loss']:.4f} "
                      f"|g| {m['g_norm']:.3e} c_k={int(m.get('c_k', 1))} "
                      f"comm {m['comm_gbits']:.3g}Gb ({m['wall_s']}s)")
    if exp.device.type == "cuda":
        torch.cuda.synchronize(exp.device)
    return RunResult(spec=spec, history=history, state=state,
                     n_params=n_params, comm_bits=comm_bits,
                     wall_s=time.time() - t0)
