"""Gradient estimators pluggable into the round engine (port of
``repro/core/estimators.py``).

Ported: ``marina``, Byz-VR-MARINA (Alg. 1): a Bernoulli(p) coin c_k
picks anchor full gradients or the compressed variance-reduced difference
g^k + Q(∇f_i(x^{k+1}) - ∇f_i(x^k)) (the reference branches with
``lax.cond``; here the coin is read on the host and a Python ``if`` takes
one branch); and ``byz_ef21``, Byz-EF21 with per-worker error feedback
under a contractive compressor. The other registry entries are named so
specs validate, and raise ``NotImplementedError`` when built.
"""
from __future__ import annotations

import dataclasses

from torch.func import grad_and_value, vmap

from repro_torch import random as R
from repro_torch.core import tree_utils as tu
from repro_torch.core.engine import (GradientEstimator, RoundOutput,
                                     message_phase, stacked_grads)


class CompressedUploadBits:
    """Comm accounting for estimators whose every upload is Q(·)."""

    def round_bits(self, cfg, d, full_round=True):
        return int(cfg.compressor.bits_per_vector(d))


@dataclasses.dataclass
class MarinaEstimator(GradientEstimator):
    """Alg. 1 (lines 4-10)."""
    name = "marina"
    rng = ("bern", "grad", "q", "attack", "agg")
    update_params_first = True

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        # paper: g^0 = ARAgg(∇f_1(x^0), ..., ∇f_n(x^0))
        k_grad, k_attack, k_agg = R.split(key, 3)
        wkeys = tu.per_worker_keys(k_grad, cfg.n_workers)
        _, grads = stacked_grads(loss_fn, params, anchor, wkeys)
        return message_phase(cfg, k_attack, k_agg, grads), {}

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None):
        from repro_torch.core import wire

        n = cfg.n_workers
        c_k = bool(R.bernoulli(keys["bern"], cfg.p))
        wkeys = tu.per_worker_keys(keys["grad"], n)
        if c_k:
            loss, grads = stacked_grads(loss_fn, params, anchor, wkeys)
            g = message_phase(cfg, keys["attack"], keys["agg"], grads,
                              sampled)
        else:
            qkeys = tu.per_worker_keys(
                keys["q"], n, common=cfg.compressor.common_randomness)

            def one(b, kg):
                gn, ln = grad_and_value(loss_fn)(params, b, kg)
                go, _ = grad_and_value(loss_fn)(old_params, b, kg)
                return ln, tu.tree_sub(gn, go)

            losses, deltas = vmap(one)(batch, wkeys)
            loss = losses.mean()
            if wire.wire_supported(cfg, deltas):
                # candidate = g^k + Q(delta): g^k rides as the shared (1, d)
                # reconstruction base, Q(delta) as the wire payload
                cand = wire.pack_candidates(cfg.compressor, qkeys, deltas,
                                            base=state["g"], base_shared=True)
            else:
                qs = tu.compress_stacked(cfg.compressor, qkeys, deltas)
                cand = {k: state["g"][k][None] + qs[k] for k in sorted(qs)}
            g = message_phase(cfg, keys["attack"], keys["agg"], cand,
                              sampled)
        dims = [p.numel() for p in tu.leaves(params)]
        wire_bits = (32.0 * sum(dims) if c_k else wire.tree_wire_bits(
            cfg.compressor, tu.tree_map(lambda p: p[None], params)))
        return RoundOutput(loss=loss, g_new=g,
                           metrics={"c_k": int(c_k), "wire_bits": wire_bits})

    def round_bits(self, cfg, d, full_round=True):
        if full_round:
            return 32 * d
        return int(cfg.compressor.bits_per_vector(d))


@dataclasses.dataclass
class ByzEF21Estimator(CompressedUploadBits, GradientEstimator):
    """Byz-EF21 (Rammal et al. 2023): worker i keeps an estimate g_i of its
    local gradient, uploads c_i = C(∇f_i(x^{k+1}) - g_i) every round, and
    both sides update g_i <- g_i + c_i; the server robust-aggregates the
    reconstructed g_i. Gradients are taken on the anchor set. On the wire
    the payload carries C(·) with g_i as its per-worker (n-row) base."""
    name = "byz_ef21"
    rng = ("grad", "q", "attack", "agg")
    update_params_first = True

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        # g_i^0 = ∇f_i(x^0) uncompressed, g^0 = ARAgg(g_1^0, ..., g_n^0)
        k_grad, k_attack, k_agg = R.split(key, 3)
        wkeys = tu.per_worker_keys(k_grad, cfg.n_workers)
        _, grads = stacked_grads(loss_fn, params, anchor, wkeys)
        g_i = tu.tree_map(lambda g: g.float(), grads)
        return message_phase(cfg, k_attack, k_agg, g_i), {"worker_g": g_i}

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None):
        from repro_torch.core import wire

        n = cfg.n_workers
        wkeys = tu.per_worker_keys(keys["grad"], n)
        qkeys = tu.per_worker_keys(keys["q"], n,
                                   common=cfg.compressor.common_randomness)

        def one(b, kg, g_i):
            g, ln = grad_and_value(loss_fn)(params, b, kg)
            return ln, tu.tree_map(lambda a, gi: a.float() - gi, g, g_i)

        losses, diffs = vmap(one)(anchor, wkeys, state["worker_g"])
        metrics = {"wire_bits": wire.tree_wire_bits(cfg.compressor, diffs)}
        if wire.wire_supported(cfg, diffs):
            cand = wire.pack_candidates(cfg.compressor, qkeys, diffs,
                                        base=state["worker_g"])
            g_new = tu.tree_add(state["worker_g"],
                                wire.decoded_payload(cand))
        else:
            c = tu.compress_stacked(cfg.compressor, qkeys, diffs)
            cand = g_new = tu.tree_add(state["worker_g"], c)
        return RoundOutput(loss=losses.mean(), cand=cand,
                           updates={"worker_g": g_new}, metrics=metrics)


def _marina_factory(cfg, **kw):
    return MarinaEstimator(**kw)


def _ef21_factory(cfg, **kw):
    if cfg.compressor.contractive_fn is None:
        raise ValueError(
            "byz_ef21 needs a contractive compressor (topk / sign / "
            "identity — Compressor.contractive_delta must be defined): the "
            "EF21 recursion contracts the error-feedback state, and "
            f"unbiasedness scaling breaks it; got {cfg.compressor.name!r}")
    return ByzEF21Estimator(**kw)


def _not_ported(name):
    def factory(cfg, **kw):
        raise NotImplementedError(
            f"method {name!r} is not ported yet (ROADMAP queue 1, item 6)")
    return factory


ESTIMATORS = {
    "marina": _marina_factory,
    "byz_ef21": _ef21_factory,
    **{nm: _not_ported(nm) for nm in ("sgd", "sgdm", "csgd", "diana", "mvr",
                                      "svrg", "cmfilter", "saga")},
}


def get_estimator(name: str, cfg, **kw) -> GradientEstimator:
    if name not in ESTIMATORS:
        raise KeyError(f"unknown method {name!r}; known: {sorted(ESTIMATORS)}")
    return ESTIMATORS[name](cfg, **kw)
