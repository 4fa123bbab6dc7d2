"""The Byzantine-robust round engine (port of ``repro/core/engine.py``).

One round: parameter update, data corruption, the estimator's
candidates, the omniscient attack, robust aggregation, the step. Under
``agg_mode="pallas"`` a kernel-fusable attack is injected inside the
robust-aggregation kernel's load.

The chaos layer hooks into the message phase: ``cfg.fault_plan`` injects
message-site faults into the candidates before the attack, and
``cfg.fault_guard`` routes to ``guarded_message_phase``, where rows that
are not finite get zero weight. Partial participation (``cfg.n_active``)
samples a cohort per round (``sampled_worker_mask``), passed as an
argument to the message phase (the reference publishes it through a
module-level cell), aggregates over it alone, and freezes the per-worker
state of the others (``carry_unsampled_state``).

``make_engine_step(..., trace=True)`` builds the telemetry twin
(``Method.step_traced``): the message phase takes ``trace=True``, runs
the same kernel-driver calls with the rules' own intermediates returned,
and builds a RoundTrace after them, which the metrics gain as
``"trace"``; one code path, so the trajectory is the untraced step's, bit
for bit. Estimators that own their message phase take the flag as an
argument, as ``sampled``, and call ``phase_with_trace``.

``ingest_message_phase`` is the streaming service's entry to the message
phase (``serve.service``): it aggregates a buffer of K updates, with the
byzantine mask over the buffered entries given per call and the
service's staleness weights scaling the sent rows before bucketing (on
the kernels, inside the bucket operator W).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch import random as R
from repro_torch.core import tree_utils as tu

AGG_BACKENDS = ("gspmd", "all_to_all", "sparse_support", "pallas")
PORTED_BACKENDS = ("gspmd", "sparse_support", "pallas")


def apply_attack(cfg, key, cand: dict, stats_valid=None,
                 mask=None) -> dict:
    """The vectors actually sent: byzantine rows replaced by the attack,
    computed from the good workers' per-coordinate mean/std.
    ``stats_valid`` (fault guard, participation) restricts the statistics
    to valid rows. ``mask`` (the streaming service: which buffered
    entries came from byzantine clients) replaces ``cfg.byz_mask()``."""
    if cfg.attack.name in ("NA", "LF") or (mask is None and cfg.n_byz == 0):
        return cand
    if mask is None:
        mask = cfg.byz_mask(tu.leaves(cand)[0].device)
    good = ~mask if stats_valid is None else ~mask & stats_valid
    means, stds = tu.masked_mean_std(cand, good,
                                     sanitize=stats_valid is not None)

    def leaf(h, m, s):
        v = cfg.attack.apply(key, h, m, s).to(h.dtype)
        return torch.where(mask.reshape((-1,) + (1,) * (h.dim() - 1)), v, h)

    return tu.tree_map(leaf, cand, means, stds)


def stacked_grads(loss_fn, params: dict, batches: dict, keys):
    """Per-worker (loss, grad) over the leading axis of ``batches``:
    ``torch.func.vmap`` over ``grad_and_value``. -> (mean loss, grads)."""
    def one(batch, key):
        grads, loss = grad_and_value(loss_fn)(params, batch, key)
        return loss, grads

    losses, grads = vmap(one)(batches, keys)
    return losses.mean(), grads


def aggregate(cfg, key, sent: dict, valid=None, return_info: bool = False,
              weights=None):
    """Backend dispatch for g = ARAgg(sent_1, ..., sent_n); ``valid``
    (n,) gives invalid rows zero weight through the masked twins.
    ``sparse_support`` changes only MARINA's VR rounds (the estimator
    aggregates the shared support itself); every other aggregation under
    it is the gspmd one. ``return_info`` (the telemetry twin) returns
    ``(agg, info)``, the rules' intermediates, from the same calls.
    ``weights`` (n,) scale each sent row before bucketing and the rule
    (the streaming service's staleness weights): the kernels carry them
    in the bucket operator, the plain backend scales the tree (the
    reference for both)."""
    if cfg.agg_mode in ("gspmd", "sparse_support"):
        if weights is not None:
            sent = _scaled(sent, weights)
        if valid is not None:
            return cfg.aggregator.tree_masked(key, sent, valid,
                                              return_info=return_info)
        if return_info:
            return cfg.aggregator.tree_traced(key, sent)
        return cfg.aggregator.tree(key, sent)
    if cfg.agg_mode == "pallas":
        from repro_torch.core.sharded_agg import tree_aggregate_pallas
        return tree_aggregate_pallas(cfg, key, sent, valid=valid,
                                     return_info=return_info,
                                     weights=weights)
    raise NotImplementedError(
        f"agg_mode {cfg.agg_mode!r} is not ported yet (ROADMAP queue 1, "
        "item 11)")


def fusable_attack_ctx(cfg, cand: dict, mask, stats_valid=None):
    """Fused-attack context: mask plus the good workers' mean/std trees,
    computed only when the attack reads them; ``stats_valid`` restricts
    the statistics to valid rows."""
    from repro_torch.core.sharded_agg import AttackCtx
    means = stds = None
    if cfg.attack.needs_mean or cfg.attack.needs_std:
        good = ~mask if stats_valid is None else ~mask & stats_valid
        means, stds = tu.masked_mean_std(cand, good,
                                         sanitize=stats_valid is not None)
        if not cfg.attack.needs_std:
            stds = None
    return AttackCtx(fn=cfg.attack.coord_apply, mask=mask, means=means,
                     stds=stds)


# fold_in salt of the participation stream, apart from the fault layer's
# 0xFA17, so the attack, fault and participation streams are independent
_PART_SALT = 0x5A3B1E


def sampled_worker_mask(cfg, step_key):
    """(n,) bool: this round's uniformly sampled cohort, or None under
    full participation. A uniform n_active-subset without replacement:
    rank the workers by a permutation drawn from fold_in(step key,
    ``_PART_SALT``) and take the first ``n_active``."""
    if cfg.n_active is None or cfg.n_active >= cfg.n_workers:
        return None
    rank = R.permutation(R.fold_in(step_key, _PART_SALT), cfg.n_workers)
    return rank < cfg.n_active


def _fusable(cfg, mask=None) -> bool:
    """The pallas backend with no attack, or one that rides into the
    kernels' load."""
    return cfg.agg_mode == "pallas" and (
        clean_attack(cfg, mask) or cfg.attack.coord_apply is not None)


def clean_attack(cfg, mask=None) -> bool:
    """No byzantine row is forged: NA / LF, or no byzantines and no
    per-call ``mask``."""
    return cfg.attack.name in ("NA", "LF") or (mask is None
                                               and cfg.n_byz == 0)


def _fused_phase(cfg, agg_key, cand, valid=None, return_info: bool = False,
                 mask=None, weights=None):
    """Attack and aggregation in the kernels (``_fusable`` configs), the
    attack's statistics and the aggregate over the ``valid`` rows;
    ``mask`` replaces ``cfg.byz_mask()``, ``weights`` ride in W."""
    from repro_torch.core.sharded_agg import tree_aggregate_pallas
    ctx = None
    if not clean_attack(cfg, mask):
        if mask is None:
            mask = cfg.byz_mask(tu.leaves(cand)[0].device)
        ctx = fusable_attack_ctx(cfg, cand, mask, stats_valid=valid)
    return tree_aggregate_pallas(cfg, agg_key, cand, attack_ctx=ctx,
                                 valid=valid, return_info=return_info,
                                 weights=weights)


def _fault_mask(cfg, attack_key, trace, n, kinds):
    """(n,) the rows the fault plan hit this round (recomputed from the
    plan and the attack key), for the trace alone; None untraced or
    without a plan."""
    if not trace or cfg.fault_plan is None:
        return None
    from repro_torch.faults import inject
    return inject.injected_mask(cfg.fault_plan, attack_key, n, kinds)


def _result(cfg, agg_key, out, trace, sent, **kw):
    """A phase's result: the backend's aggregate or, with ``trace``,
    ``(agg, RoundTrace)`` from its ``(agg, info)`` and the attacked stack
    ``sent`` (a thunk where the kernels attacked in their load: the trace
    alone materializes it)."""
    if not trace:
        return out
    from repro_torch.obs import trace as obs_trace
    agg, info = out
    if callable(sent):
        sent = sent()
    return agg, obs_trace._build_trace(cfg, agg_key, sent, agg, info=info,
                                       **kw)


def participating_message_phase(cfg, attack_key, agg_key, cand, sampled,
                                trace=False):
    """``message_phase`` over the sampled cohort: non-sampled rows get zero
    weight through the masked twins, the attack's statistics see only the
    sampled good workers, and under the guard the validity is ``sampled``
    and finite. A ``WireCandidates`` payload is reconstructed densely
    first, after its faults are injected."""
    from repro_torch.core import wire
    from repro_torch.faults import guard as fguard, inject
    plan = cfg.fault_plan
    if isinstance(cand, wire.WireCandidates):
        if plan is not None and plan.message_faults:
            cand = inject.inject_wire(plan, attack_key, cand)
        fault_mask = _fault_mask(cfg, attack_key, trace, cand.n,
                                 inject.MESSAGE_FAULTS)
        cand = wire.reconstruct(cand)
    else:
        if plan is not None and plan.tensor_faults:
            cand = inject.inject_candidates(plan, attack_key, cand)
        fault_mask = _fault_mask(cfg, attack_key, trace,
                                 tu.leaves(cand)[0].shape[0],
                                 inject.TENSOR_FAULTS)
    kw = dict(fault_mask=fault_mask, sampled=sampled)
    if cfg.fault_guard:
        valid_pre = fguard.finite_row_mask(cand) & sampled
        sent = apply_attack(cfg, attack_key, cand, stats_valid=valid_pre)
        valid = fguard.finite_row_mask(sent) & sampled
        out = aggregate(cfg, agg_key, sent, valid=valid, return_info=trace)
        return _result(cfg, agg_key, out, trace, sent, valid=valid, **kw)
    kw.update(valid=sampled, record_guard=False)
    if _fusable(cfg):
        out = _fused_phase(cfg, agg_key, cand, sampled, return_info=trace)
        return _result(cfg, agg_key, out, trace,
                       lambda: apply_attack(cfg, attack_key, cand,
                                            stats_valid=sampled), **kw)
    sent = apply_attack(cfg, attack_key, cand, stats_valid=sampled)
    out = aggregate(cfg, agg_key, sent, valid=sampled, return_info=trace)
    return _result(cfg, agg_key, out, trace, sent, **kw)


def guarded_message_phase(cfg, attack_key, agg_key, cand, trace=False,
                          fault_mask=None):
    """Fail-closed twin of ``message_phase`` over dense candidates: rows
    that are not finite in every coordinate get zero weight, as if the
    workers had been dropped. The attack's statistics see only honest and
    valid rows. On the fused path the validity stays the pre-attack one
    (the load zeroes a byzantine row that is also faulty, after the
    attack); materializing paths re-check the attacked tensor, so even a
    non-finite attack output fails closed."""
    from repro_torch.faults import guard as fguard
    valid_pre = fguard.finite_row_mask(cand)
    if _fusable(cfg):
        out = _fused_phase(cfg, agg_key, cand, valid_pre, return_info=trace)
        return _result(cfg, agg_key, out, trace,
                       lambda: apply_attack(cfg, attack_key, cand,
                                            stats_valid=valid_pre),
                       valid=valid_pre, fault_mask=fault_mask)
    sent = apply_attack(cfg, attack_key, cand, stats_valid=valid_pre)
    valid = fguard.finite_row_mask(sent)
    out = aggregate(cfg, agg_key, sent, valid=valid, return_info=trace)
    return _result(cfg, agg_key, out, trace, sent, valid=valid,
                   fault_mask=fault_mask)


def message_phase(cfg, attack_key, agg_key, cand, sampled=None,
                  trace=False, byz_mask=None, weights=None):
    """Lines 9-10 of the round: omniscient attack, then robust
    aggregation. ``cand`` is a stacked dense tree or, on the wire path, a
    ``wire.WireCandidates`` payload. A fault plan injects its message
    faults first; ``cfg.fault_guard`` takes the guarded phases;
    ``sampled`` (the round's cohort) takes
    ``participating_message_phase``. ``trace`` (the telemetry twin)
    returns ``(agg, RoundTrace)``: the same calls, with the backends'
    ``return_info``, and the trace built after them
    (``obs.trace._build_trace``). ``byz_mask`` and ``weights`` are the
    streaming service's (``ingest_message_phase``), over dense
    candidates at full participation: the attack's mask in place of
    ``cfg.byz_mask()``, and each sent row's scale before bucketing and
    the rule (on the kernels, inside W)."""
    from repro_torch.core import wire
    from repro_torch.faults import guard as fguard, inject
    if sampled is not None:
        return participating_message_phase(cfg, attack_key, agg_key, cand,
                                           sampled, trace)
    plan = cfg.fault_plan
    if isinstance(cand, wire.WireCandidates):
        if plan is not None and plan.message_faults:
            cand = inject.inject_wire(plan, attack_key, cand)
        out = wire.wire_message_phase(cfg, attack_key, agg_key, cand,
                                      return_info=trace)
        if not trace:
            return out
        agg, info, valid = out
        return _result(cfg, agg_key, (agg, info), trace,
                       lambda: apply_attack(cfg, attack_key,
                                            wire.reconstruct(cand),
                                            stats_valid=valid),
                       valid=valid,
                       fault_mask=_fault_mask(cfg, attack_key, trace, cand.n,
                                              inject.MESSAGE_FAULTS))
    if plan is not None and plan.tensor_faults:
        cand = inject.inject_candidates(plan, attack_key, cand)
    fault_mask = _fault_mask(cfg, attack_key, trace,
                             tu.leaves(cand)[0].shape[0],
                             inject.TENSOR_FAULTS)
    ingest = byz_mask is not None or weights is not None
    if cfg.fault_guard and not ingest:
        return guarded_message_phase(cfg, attack_key, agg_key, cand, trace,
                                     fault_mask)
    kw = dict(fault_mask=fault_mask, byz_mask=byz_mask, weights=weights)
    if cfg.fault_guard:
        # the reference's guarded ingest: the attack is materialized and
        # the rows it leaves not finite get zero weight
        valid_pre = fguard.finite_row_mask(cand)
        sent = apply_attack(cfg, attack_key, cand, stats_valid=valid_pre,
                            mask=byz_mask)
        valid = fguard.finite_row_mask(sent)
        out = aggregate(cfg, agg_key, sent, valid=valid, return_info=trace,
                        weights=weights)
        return _result(cfg, agg_key, out, trace, sent, valid=valid, **kw)
    if _fusable(cfg, byz_mask):
        out = _fused_phase(cfg, agg_key, cand, return_info=trace,
                           mask=byz_mask, weights=weights)
        return _result(cfg, agg_key, out, trace,
                       lambda: apply_attack(cfg, attack_key, cand,
                                            mask=byz_mask), **kw)
    sent = apply_attack(cfg, attack_key, cand, mask=byz_mask)
    out = aggregate(cfg, agg_key, sent, return_info=trace, weights=weights)
    return _result(cfg, agg_key, out, trace, sent, **kw)


def _scaled(sent: dict, weights) -> dict:
    """Each row times its weight, in float32, back in the leaf's dtype:
    what the kernels' W = W_bucket · diag(w) applies in their load."""
    w = weights.float()
    return tu.tree_map(lambda a: (a.float() * w.reshape(
        (-1,) + (1,) * (a.dim() - 1))).to(a.dtype), sent)


def ingest_message_phase(cfg, attack_key, agg_key, cand, *, byz_mask=None,
                         weights=None, trace=False):
    """Lines 9-10 over a buffer of K updates (the streaming service):
    ``message_phase`` with ``byz_mask`` (K,) bool, which buffered entries
    came from byzantine clients, and ``weights`` (K,) float32, the
    service's staleness weights (so that ``mean`` gives the FedBuff
    weighted mean). With both omitted this is ``message_phase``. Wire
    payloads raise ``TypeError``: the buffer holds dense updates."""
    from repro_torch.core import wire
    if isinstance(cand, wire.WireCandidates):
        raise TypeError(
            "ingest_message_phase aggregates dense buffered updates; decode "
            "wire payloads at ingest (serve/buffer.py) before firing")
    return message_phase(cfg, attack_key, agg_key, cand, trace=trace,
                         byz_mask=byz_mask, weights=weights)


def phase_with_trace(cfg, attack_key, agg_key, cand, sampled=None,
                     trace=False):
    """``(message_phase(...), None)``, or with ``trace`` ``(agg,
    RoundTrace)``: for estimators that run the message phase themselves
    (MARINA's two branches)."""
    out = message_phase(cfg, attack_key, agg_key, cand, sampled, trace)
    return out if trace else (out, None)


def carry_unsampled_state(state: dict, updates: dict, sampled,
                          n_workers: int) -> dict:
    """Freeze the per-worker state of the workers not sampled this round:
    they neither computed nor uploaded anything. Per-worker state is
    marked by the ``worker_`` key prefix (every leaf's leading axis is
    n_workers); for those keys the round's update is merged row-wise with
    the previous state. Server-side updates pass through."""
    out = {}
    for k, new in updates.items():
        old = state.get(k)
        if old is None or not k.startswith("worker_"):
            out[k] = new
            continue

        def merge(nl, ol):
            assert nl.shape[0] == n_workers, (k, nl.shape)
            keep = sampled.reshape((-1,) + (1,) * (nl.dim() - 1))
            return torch.where(keep, nl, ol)

        out[k] = tu.tree_map(merge, new, old)
    return out


def param_update(cfg, params: dict, g: dict, opt_state):
    """x <- x - γ g (dtype-preserving, float32 math); optimizers are not
    ported yet."""
    return tu.tree_map(lambda x, gg: (x.float() - cfg.lr * gg.float())
                       .to(x.dtype), params, g), opt_state


def maybe_corrupt(cfg, corrupt_fn, batch):
    """Data-level attacks (label flipping) on the byzantine workers."""
    if corrupt_fn is not None and cfg.attack.flips_labels and cfg.n_byz:
        return corrupt_fn(batch, cfg.byz_mask(tu.leaves(batch)[0].device))
    return batch


@dataclasses.dataclass
class RoundOutput:
    """What an estimator hands the engine: ``cand`` (attacked and
    aggregated by the engine, optionally post-processed by ``finalize``)
    or ``g_new`` (the estimator ran the message phase itself, with its
    RoundTrace in ``trace`` when the telemetry twin runs)."""
    loss: Any
    cand: Any = None
    finalize: Optional[Callable] = None
    g_new: Any = None
    updates: Optional[dict] = None
    metrics: Optional[dict] = None
    trace: Any = None


class GradientEstimator:
    """Pluggable per-worker gradient estimator (see the reference).
    ``seed_batchable`` False keeps a method's state off a vmap over seeds
    (per-worker gradient tables); ``streamable`` True marks a candidate
    that is a pure per-client function of (params, batch, local state)."""
    name: str = "?"
    rng: tuple = ("grad", "attack", "agg")
    update_params_first: bool = False
    seed_batchable: bool = True
    streamable: bool = False

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        raise NotImplementedError

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None, trace=False) -> RoundOutput:
        """``sampled``: the round's cohort (None at full participation);
        ``trace``: whether the telemetry twin runs. Both for estimators
        that run the message phase themselves (``phase_with_trace``)."""
        raise NotImplementedError

    def round_bits(self, cfg, d: int, full_round: bool = True) -> int:
        return 32 * d

    def expected_bits(self, cfg, d: int) -> float:
        return float(self.round_bits(cfg, d))


def make_engine_init(cfg, loss_fn, estimator: GradientEstimator,
                     corrupt_fn: Optional[Callable] = None):
    def init(params, anchor, key):
        if anchor is not None:
            anchor = maybe_corrupt(cfg, corrupt_fn, anchor)
        g0, extras = estimator.init_extras(cfg, loss_fn, params, anchor, key)
        return {"params": params, "g": g0, "opt_state": None, "step": 0,
                **extras}

    return init


def make_engine_step(cfg, loss_fn, estimator: GradientEstimator,
                     corrupt_fn: Optional[Callable] = None,
                     trace: bool = False):
    """The round. ``trace=True`` builds the telemetry twin: the same
    aggregation calls with ``message_phase(..., trace=True)``, and the
    metrics gain ``"trace"``, the RoundTrace (None where an estimator
    aggregated without the shared phase: sparse-support rounds)."""
    est = estimator
    assert est.rng[-2:] == ("attack", "agg"), est.rng

    def step(state, batch, anchor, key):
        keys = dict(zip(est.rng, R.split(key, len(est.rng))))
        old_params = state["params"]
        sampled = sampled_worker_mask(cfg, key)
        if est.update_params_first:
            new_params, new_opt = param_update(cfg, old_params, state["g"],
                                               state["opt_state"])
        else:
            new_params, new_opt = old_params, state["opt_state"]
        batch = maybe_corrupt(cfg, corrupt_fn, batch)
        anchor = maybe_corrupt(cfg, corrupt_fn, anchor)
        ro = est.round(cfg, loss_fn, state, new_params, old_params, batch,
                       anchor, keys, sampled=sampled, trace=trace)
        updates = dict(ro.updates or {})
        rt = None
        if ro.g_new is not None:
            g = ro.g_new
            rt = ro.trace
        else:
            agg, rt = phase_with_trace(cfg, keys["attack"], keys["agg"],
                                       ro.cand, sampled, trace)
            if ro.finalize is not None:
                g, fin_updates = ro.finalize(agg)
                updates.update(fin_updates)
            else:
                g = agg
        if sampled is not None:
            updates = carry_unsampled_state(state, updates, sampled,
                                            cfg.n_workers)
        if not est.update_params_first:
            new_params, new_opt = param_update(cfg, old_params, g,
                                               state["opt_state"])
        new_state = {**state, **updates, "params": new_params, "g": g,
                     "opt_state": new_opt, "step": state["step"] + 1}
        metrics = {"loss": ro.loss, **(ro.metrics or {}),
                   "g_norm": torch.sqrt(tu.tree_norm_sq(g))}
        if trace:
            metrics["trace"] = rt
        return new_state, metrics

    return step


@dataclasses.dataclass(frozen=True)
class Method:
    """A Byzantine-robust training method over the shared engine;
    ``step_traced`` is the telemetry twin of ``step`` (metrics carry a
    ``"trace"`` RoundTrace, the trajectory is the same bit for bit)."""
    name: str
    estimator: GradientEstimator
    init: Callable
    step: Callable
    cfg: Any
    step_traced: Optional[Callable] = None

    def round_bits(self, d: int, full_round: bool = True) -> int:
        return self.estimator.round_bits(self.cfg, d, full_round)

    def expected_bits(self, d: int) -> float:
        return self.estimator.expected_bits(self.cfg, d)


def make_method(name: str, cfg, loss_fn,
                corrupt_fn: Optional[Callable] = None, **est_kw) -> Method:
    from repro_torch.core import estimators as E
    est = E.get_estimator(name, cfg, **est_kw)
    return Method(name=name, estimator=est, cfg=cfg,
                  init=make_engine_init(cfg, loss_fn, est, corrupt_fn),
                  step=make_engine_step(cfg, loss_fn, est, corrupt_fn),
                  step_traced=make_engine_step(cfg, loss_fn, est, corrupt_fn,
                                               trace=True))


def list_methods():
    from repro_torch.core import estimators as E
    return sorted(E.ESTIMATORS)
