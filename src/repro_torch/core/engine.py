"""The Byzantine-robust round engine (port of ``repro/core/engine.py``).

One round: parameter update, data corruption, the estimator's
candidates, the omniscient attack, robust aggregation, the step. Under
``agg_mode="pallas"`` a kernel-fusable attack is injected inside the
robust-aggregation kernel's load. Partial participation, the fault layer,
telemetry twins and the buffered-ingest phase are not ported yet (ROADMAP
queue 1, items 7, 8 and 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch import random as R
from repro_torch.core import tree_utils as tu

AGG_BACKENDS = ("gspmd", "all_to_all", "sparse_support", "pallas")
PORTED_BACKENDS = ("gspmd", "pallas")


def apply_attack(cfg, key, cand: dict) -> dict:
    """The vectors actually sent: byzantine rows replaced by the attack,
    computed from the good workers' per-coordinate mean/std."""
    if cfg.attack.name in ("NA", "LF") or cfg.n_byz == 0:
        return cand
    mask = cfg.byz_mask(tu.leaves(cand)[0].device)
    means, stds = tu.masked_mean_std(cand, ~mask)

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


def aggregate(cfg, key, sent: dict) -> dict:
    """Backend dispatch for g = ARAgg(sent_1, ..., sent_n)."""
    if cfg.agg_mode == "gspmd":
        return cfg.aggregator.tree(key, sent)
    if cfg.agg_mode == "pallas":
        from repro_torch.core.sharded_agg import tree_aggregate_pallas
        return tree_aggregate_pallas(cfg, key, sent)
    raise NotImplementedError(
        f"agg_mode {cfg.agg_mode!r} is not ported yet (ROADMAP queue 1, "
        "item 11)")


def fusable_attack_ctx(cfg, cand: dict, mask):
    """Fused-attack context: mask plus the good workers' mean/std trees,
    computed only when the attack reads them."""
    from repro_torch.core.sharded_agg import AttackCtx
    means = stds = None
    if cfg.attack.needs_mean or cfg.attack.needs_std:
        means, stds = tu.masked_mean_std(cand, ~mask)
        if not cfg.attack.needs_std:
            stds = None
    return AttackCtx(fn=cfg.attack.coord_apply, mask=mask, means=means,
                     stds=stds)


def message_phase(cfg, attack_key, agg_key, cand):
    """Lines 9-10 of the round: omniscient attack, then robust
    aggregation. ``cand`` is a stacked dense tree or, on the wire path, a
    ``wire.WireCandidates`` payload."""
    from repro_torch.core import wire
    if isinstance(cand, wire.WireCandidates):
        return wire.wire_message_phase(cfg, attack_key, agg_key, cand)
    if cfg.agg_mode == "pallas":
        from repro_torch.core.sharded_agg import tree_aggregate_pallas
        if cfg.n_byz == 0 or cfg.attack.name in ("NA", "LF"):
            return tree_aggregate_pallas(cfg, agg_key, cand)
        if cfg.attack.coord_apply is not None:
            mask = cfg.byz_mask(tu.leaves(cand)[0].device)
            ctx = fusable_attack_ctx(cfg, cand, mask)
            return tree_aggregate_pallas(cfg, agg_key, cand, attack_ctx=ctx)
    sent = apply_attack(cfg, attack_key, cand)
    return aggregate(cfg, agg_key, sent)


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
    or ``g_new`` (the estimator ran the message phase itself)."""
    loss: Any
    cand: Any = None
    finalize: Optional[Callable] = None
    g_new: Any = None
    updates: Optional[dict] = None
    metrics: Optional[dict] = None


class GradientEstimator:
    """Pluggable per-worker gradient estimator (see the reference)."""
    name: str = "?"
    rng: tuple = ("grad", "attack", "agg")
    update_params_first: bool = False

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        raise NotImplementedError

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys) -> RoundOutput:
        raise NotImplementedError

    def round_bits(self, cfg, d: int, full_round: bool = True) -> int:
        return 32 * d


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
                     corrupt_fn: Optional[Callable] = None):
    est = estimator
    assert est.rng[-2:] == ("attack", "agg"), est.rng

    def step(state, batch, anchor, key):
        keys = dict(zip(est.rng, R.split(key, len(est.rng))))
        old_params = state["params"]
        if est.update_params_first:
            new_params, new_opt = param_update(cfg, old_params, state["g"],
                                               state["opt_state"])
        else:
            new_params, new_opt = old_params, state["opt_state"]
        batch = maybe_corrupt(cfg, corrupt_fn, batch)
        anchor = maybe_corrupt(cfg, corrupt_fn, anchor)
        ro = est.round(cfg, loss_fn, state, new_params, old_params, batch,
                       anchor, keys)
        updates = dict(ro.updates or {})
        if ro.g_new is not None:
            g = ro.g_new
        else:
            agg = message_phase(cfg, keys["attack"], keys["agg"], ro.cand)
            if ro.finalize is not None:
                g, fin_updates = ro.finalize(agg)
                updates.update(fin_updates)
            else:
                g = agg
        if not est.update_params_first:
            new_params, new_opt = param_update(cfg, old_params, g,
                                               state["opt_state"])
        new_state = {**state, **updates, "params": new_params, "g": g,
                     "opt_state": new_opt, "step": state["step"] + 1}
        metrics = {"loss": ro.loss, **(ro.metrics or {}),
                   "g_norm": torch.sqrt(tu.tree_norm_sq(g))}
        return new_state, metrics

    return step


@dataclasses.dataclass(frozen=True)
class Method:
    """A Byzantine-robust training method over the shared engine."""
    name: str
    estimator: GradientEstimator
    init: Callable
    step: Callable
    cfg: Any

    def round_bits(self, d: int, full_round: bool = True) -> int:
        return self.estimator.round_bits(self.cfg, d, full_round)


def make_method(name: str, cfg, loss_fn,
                corrupt_fn: Optional[Callable] = None, **est_kw) -> Method:
    from repro_torch.core import estimators as E
    est = E.get_estimator(name, cfg, **est_kw)
    return Method(name=name, estimator=est, cfg=cfg,
                  init=make_engine_init(cfg, loss_fn, est, corrupt_fn),
                  step=make_engine_step(cfg, loss_fn, est, corrupt_fn))
