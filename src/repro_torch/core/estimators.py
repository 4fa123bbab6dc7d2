"""Gradient estimators pluggable into the round engine (port of
``repro/core/estimators.py``).

Each estimator owns what distinguishes its method: its per-worker
candidates, its extra worker / server state and its communication cost.
The engine does the parameter update, the attack, the robust aggregation
and the metrics.

  marina   — Byz-VR-MARINA (Alg. 1): a Bernoulli(p) coin c_k picks anchor
             full gradients or g^k + Q(∇f_i(x^{k+1}) - ∇f_i(x^k)).
  sgd      — Parallel-SGD; ``sgdm`` BR-SGDm (worker momenta attacked and
             aggregated).
  csgd     — compressed SGD; with a robust rule BR-CSGD.
  diana    — BR-DIANA: worker shifts h_i, uploads Q(g_i - h_i).
  mvr      — BR-MVR (STORM momentum variance reduction).
  svrg     — Byrd-SVRG, loopless (App. B.4).
  byz_ef21 — Byz-EF21: contractive compressor and per-worker error
             feedback.
  cmfilter — compressed momentum filtering: worker momenta uploaded as
             compressed differences against a server-mirrored copy.
  saga     — Byrd-SAGA over the stacked protocol: per-worker per-sample
             gradient tables over the anchor.

Where the reference branches on a Bernoulli coin with ``lax.cond``
(MARINA's c_k, SVRG's refresh), the coin is read on the host and a
Python ``if`` computes only the branch taken. Under
``agg_mode="sparse_support"`` MARINA takes ``MarinaSparseEstimator``:
common-randomness RandK, whose VR rounds attack and aggregate the shared
support alone, with the rule's plain tree (no kernel, as in the
reference).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.func import grad_and_value

from repro_torch import random as R
from repro_torch.core import tree_utils as tu
from repro_torch.core.aggregators import mean0, xla_sum_rows
from repro_torch.core.engine import (GradientEstimator, RoundOutput,
                                     apply_attack, message_phase,
                                     phase_with_trace, stacked_grads,
                                     worker_vmap)


class CompressedUploadBits:
    """Comm accounting for estimators whose every upload is Q(·)."""

    def round_bits(self, cfg, d, full_round=True):
        return int(cfg.compressor.bits_per_vector(d))

    def expected_bits(self, cfg, d):
        return float(cfg.compressor.bits_per_vector(d))


def _grad_delta(loss_fn, params, old_params):
    """(batch, key) -> (loss at params, ∇f(params) − ∇f(old_params)): the
    difference taken in place, each old gradient dropped as it is used,
    so at most two model-sized gradient stacks are alive under vmap."""
    def one(b, kg):
        gn, ln = grad_and_value(loss_fn)(params, b, kg)
        go, _ = grad_and_value(loss_fn)(old_params, b, kg)
        for k in sorted(gn):
            gn[k] = gn[k].sub_(go.pop(k))
        return ln, gn
    return one


def _zeros_like_f32(params):
    return tu.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                       params)


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
              keys, sampled=None, trace=False):
        from repro_torch.core import wire

        n = cfg.n_workers
        c_k = bool(R.bernoulli(keys["bern"], cfg.p))
        wkeys = tu.per_worker_keys(keys["grad"], n)
        if c_k:
            loss, grads = stacked_grads(loss_fn, params, anchor, wkeys)
            g, rt = phase_with_trace(cfg, keys["attack"], keys["agg"], grads,
                                     sampled, trace)
        else:
            qkeys = tu.per_worker_keys(
                keys["q"], n, common=cfg.compressor.common_randomness)

            losses, deltas = worker_vmap(
                loss_fn, _grad_delta(loss_fn, params, old_params))(batch,
                                                                    wkeys)
            loss = losses.mean()
            if wire.wire_supported(cfg, deltas):
                # candidate = g^k + Q(delta): g^k rides as the shared (1, d)
                # reconstruction base, Q(delta) as the wire payload
                cand = wire.pack_candidates(cfg.compressor, qkeys, deltas,
                                            base=state["g"], base_shared=True)
            else:
                cand = tu.compress_stacked(cfg.compressor, qkeys, deltas,
                                           base=state["g"], consume=True)
            del deltas
            g, rt = phase_with_trace(cfg, keys["attack"], keys["agg"], cand,
                                     sampled, trace)
        dims = [p.numel() for p in tu.leaves(params)]
        wire_bits = (32.0 * sum(dims) if c_k else wire.tree_wire_bits(
            cfg.compressor, tu.tree_map(lambda p: p[None], params)))
        return RoundOutput(loss=loss, g_new=g, trace=rt,
                           metrics={"c_k": int(c_k), "wire_bits": wire_bits})

    def round_bits(self, cfg, d, full_round=True):
        if full_round:
            return 32 * d
        return int(cfg.compressor.bits_per_vector(d))

    def expected_bits(self, cfg, d):
        return (cfg.p * 32 * d
                + (1 - cfg.p) * cfg.compressor.bits_per_vector(d))


def _support_take(flat, idx, blk: int):
    """(..., d) -> (..., K, blk): the K selection units ``idx`` of each
    row, the last unit zero-padded."""
    xf = torch.nn.functional.pad(flat, (0, (-flat.shape[-1]) % blk))
    return xf.reshape(flat.shape[:-1] + (-1, blk))[..., idx, :]


def _support_put(leaf, idx, blk: int, vals):
    """``leaf`` with its K units ``idx`` set to ``vals`` (K, blk), in
    float32; every other coordinate unchanged."""
    d = leaf.numel()
    xf = torch.nn.functional.pad(leaf.reshape(-1).float(), (0, (-d) % blk))
    xf = xf.reshape(-1, blk).clone()
    xf[idx] = vals.float()
    return xf.reshape(-1)[:d].reshape(leaf.shape).to(leaf.dtype)


@dataclasses.dataclass
class MarinaSparseEstimator(MarinaEstimator):
    """Sparse-support MARINA: common-randomness RandK, so every worker
    sends the same K units of each leaf, and a VR round attacks and
    aggregates those units alone (the rule's plain tree over the (n, K,
    blk) leaves); off the support g^k stays as it was, bit for bit.
    Full rounds attack and aggregate the dense gradients the same way.
    No kernel runs on this path, in the reference or here."""
    name = "marina_sparse"

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None, trace=False):
        from repro_torch.core.compressors import unit_partition

        n = cfg.n_workers
        ratio = cfg.compressor.ratio          # checked by _marina_factory
        c_k = bool(R.bernoulli(keys["bern"], cfg.p))
        wkeys = tu.per_worker_keys(keys["grad"], n)
        if c_k:
            loss, grads = stacked_grads(loss_fn, params, anchor, wkeys)
            sent = apply_attack(cfg, keys["attack"], grads)
            return RoundOutput(loss=loss,
                               g_new=cfg.aggregator.tree(keys["agg"], sent),
                               metrics={"c_k": 1})
        # the shared per-leaf supports: the same key for every worker
        names = sorted(state["g"])
        meta = []
        for i, name in enumerate(names):
            blk, n_units = unit_partition(state["g"][name].numel())
            k_units = max(int(ratio * n_units), 1)
            idx = R.permutation(R.fold_in(keys["q"], i), n_units)[:k_units]
            meta.append((blk, idx, n_units / k_units))

        losses, deltas = worker_vmap(
            loss_fn, _grad_delta(loss_fn, params, old_params))(batch, wkeys)
        # the candidates on the support: g^k's units plus the scaled
        # delta's, one leaf per name (the reference's tuple, in its order)
        cand = {}
        for name, (blk, idx, scale) in zip(names, meta):
            dv = _support_take(deltas[name].reshape(n, -1).float(), idx,
                               blk) * scale
            base = _support_take(state["g"][name].reshape(-1).float(), idx,
                                 blk)
            cand[name] = base[None] + dv
        sent = apply_attack(cfg, keys["attack"], cand)
        agg = cfg.aggregator.tree(keys["agg"], sent)
        g_new = {name: _support_put(state["g"][name], idx, blk, agg[name])
                 for name, (blk, idx, _) in zip(names, meta)}
        return RoundOutput(loss=losses.mean(), g_new=g_new,
                           metrics={"c_k": 0})


@dataclasses.dataclass
class SGDEstimator(GradientEstimator):
    """momentum=0: Parallel-SGD; momentum>0: BR-SGDm, whose worker momenta
    are what is attacked and aggregated."""
    momentum: float = 0.0
    name = "sgd"
    rng = ("grad", "attack", "agg")
    streamable = True

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        g0 = (_zeros_like_f32(params) if self.momentum > 0.0
              else tu.tree_zeros_like(params))
        return g0, {"worker_m": tu.tree_broadcast_leading(
            _zeros_like_f32(params), cfg.n_workers)}

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None, trace=False):
        wkeys = tu.per_worker_keys(keys["grad"], cfg.n_workers)
        loss, grads = stacked_grads(loss_fn, params, batch, wkeys)
        if self.momentum > 0.0:
            beta = self.momentum
            m_new = tu.tree_map(
                lambda m, g: (1 - beta) * g.float() + beta * m.float(),
                state["worker_m"], grads)
            cand = m_new
        else:
            m_new = state["worker_m"]
            cand = grads
        return RoundOutput(loss=loss, cand=cand, updates={"worker_m": m_new})


@dataclasses.dataclass
class CSGDEstimator(CompressedUploadBits, GradientEstimator):
    """Compressed SGD: each worker uploads Q(∇f_i); on the wire the payload
    carries Q(·) with no base."""
    name = "csgd"
    rng = ("grad", "q", "attack", "agg")
    streamable = True

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        return tu.tree_zeros_like(params), {}

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None, trace=False):
        from repro_torch.core import wire

        n = cfg.n_workers
        wkeys = tu.per_worker_keys(keys["grad"], n)
        qkeys = tu.per_worker_keys(keys["q"], n,
                                   common=cfg.compressor.common_randomness)
        loss, grads = stacked_grads(loss_fn, params, batch, wkeys)
        metrics = {"wire_bits": wire.tree_wire_bits(cfg.compressor, grads)}
        if wire.wire_supported(cfg, grads):
            cand = wire.pack_candidates(cfg.compressor, qkeys, grads)
        else:
            cand = tu.compress_stacked(cfg.compressor, qkeys, grads)
        return RoundOutput(loss=loss, cand=cand, metrics=metrics)


@dataclasses.dataclass
class DianaEstimator(CompressedUploadBits, GradientEstimator):
    """DIANA: worker i keeps a shift h_i and uploads Q(g_i - h_i); the
    server adds the aggregated compressed difference to the shifts' mean.
    alpha defaults to 1/(1+ω(d)), d the model size or ``d_hint``."""
    alpha: Optional[float] = None
    d_hint: Optional[int] = None
    name = "diana"
    rng = ("grad", "q", "attack", "agg")

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        d = int(self.d_hint if self.d_hint is not None
                else tu.tree_size(params))
        omega = cfg.compressor.omega(d)
        a = self.alpha if self.alpha is not None else 1.0 / (1.0 + omega)
        device = tu.leaves(params)[0].device
        extras = {
            "worker_h": tu.tree_broadcast_leading(_zeros_like_f32(params),
                                                  cfg.n_workers),
            "alpha": torch.tensor(a, dtype=torch.float32, device=device),
        }
        return _zeros_like_f32(params), extras

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None, trace=False):
        from repro_torch.core import wire

        n = cfg.n_workers
        wkeys = tu.per_worker_keys(keys["grad"], n)
        qkeys = tu.per_worker_keys(keys["q"], n,
                                   common=cfg.compressor.common_randomness)
        h = state["worker_h"]
        a = state["alpha"]

        def one(b, kg, h_i):
            g, ln = grad_and_value(loss_fn)(params, b, kg)
            return ln, tu.tree_sub(g, h_i)

        losses, diffs = worker_vmap(loss_fn, one)(batch, wkeys, h)
        metrics = {"wire_bits": wire.tree_wire_bits(cfg.compressor, diffs)}
        if wire.wire_supported(cfg, diffs):
            cand = wire.pack_candidates(cfg.compressor, qkeys, diffs)
            qdiff = wire.decoded_payload(cand)
        else:
            cand = qdiff = tu.compress_stacked(cfg.compressor, qkeys, diffs)
        h_mean = tu.tree_map(mean0, h)
        h_new = tu.tree_map(lambda hh, q: hh + a * q, h, qdiff)

        def finalize(agg_diff):
            return tu.tree_add(h_mean, agg_diff), {"worker_h": h_new}

        return RoundOutput(loss=losses.mean(), cand=cand, finalize=finalize,
                           metrics=metrics)


@dataclasses.dataclass
class MVREstimator(GradientEstimator):
    """BR-MVR: per-worker momentum variance reduction,
    v_i^k = g_i(x^k) + (1-α)(v_i^{k-1} - g_i(x^{k-1})), then robust
    aggregation."""
    alpha: float = 0.1
    name = "mvr"
    rng = ("grad", "attack", "agg")

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        # the reference hands the un-split key to per_worker_keys
        wkeys = tu.per_worker_keys(key, cfg.n_workers)
        _, grads = stacked_grads(loss_fn, params, anchor, wkeys)
        v0 = tu.tree_map(lambda g: g.float(), grads)
        return _zeros_like_f32(params), {"prev_params": params,
                                         "worker_v": v0}

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None, trace=False):
        wkeys = tu.per_worker_keys(keys["grad"], cfg.n_workers)
        prev = state["prev_params"]
        alpha = self.alpha

        def one(b, kg, v_i):
            gx, ln = grad_and_value(loss_fn)(params, b, kg)
            gp, _ = grad_and_value(loss_fn)(prev, b, kg)
            return ln, tu.tree_map(
                lambda g, vv, go: g.float() + (1 - alpha) * (vv - go.float()),
                gx, v_i, gp)

        losses, v = worker_vmap(loss_fn, one)(batch, wkeys,
                                              state["worker_v"])
        return RoundOutput(loss=losses.mean(), cand=v,
                           updates={"prev_params": params, "worker_v": v})


@dataclasses.dataclass
class SVRGEstimator(GradientEstimator):
    """Loopless SVRG: with probability p the snapshot w <- x and the full
    worker gradients refresh; worker i sends
    v_i = g_i(x, mb) - g_i(w, mb) + full_i."""
    name = "svrg"
    rng = ("bern", "grad", "attack", "agg")

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        # the reference hands the un-split key to per_worker_keys
        wkeys = tu.per_worker_keys(key, cfg.n_workers)
        _, fulls = stacked_grads(loss_fn, params, anchor, wkeys)
        return tu.tree_zeros_like(params), {"snapshot": params,
                                            "worker_full": fulls}

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None, trace=False):
        wkeys = tu.per_worker_keys(keys["grad"], cfg.n_workers)
        if bool(R.bernoulli(keys["bern"], cfg.p)):
            w = params
            _, fulls = stacked_grads(loss_fn, params, anchor, wkeys)
        else:
            w, fulls = state["snapshot"], state["worker_full"]

        def one(b, kg, full_i):
            gx, ln = grad_and_value(loss_fn)(params, b, kg)
            gw, _ = grad_and_value(loss_fn)(w, b, kg)
            return ln, tu.tree_add(tu.tree_sub(gx, gw), full_i)

        losses, cand = worker_vmap(loss_fn, one)(batch, wkeys, fulls)
        return RoundOutput(loss=losses.mean(), cand=cand,
                           updates={"snapshot": w, "worker_full": fulls})


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
    needs_contractive = True

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        # g_i^0 = ∇f_i(x^0) uncompressed, g^0 = ARAgg(g_1^0, ..., g_n^0)
        k_grad, k_attack, k_agg = R.split(key, 3)
        wkeys = tu.per_worker_keys(k_grad, cfg.n_workers)
        _, grads = stacked_grads(loss_fn, params, anchor, wkeys)
        g_i = tu.tree_map(lambda g: g.float(), grads)
        return message_phase(cfg, k_attack, k_agg, g_i), {"worker_g": g_i}

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None, trace=False):
        from repro_torch.core import wire

        n = cfg.n_workers
        wkeys = tu.per_worker_keys(keys["grad"], n)
        qkeys = tu.per_worker_keys(keys["q"], n,
                                   common=cfg.compressor.common_randomness)

        def one(b, kg, g_i):
            g, ln = grad_and_value(loss_fn)(params, b, kg)
            return ln, tu.tree_map(lambda a, gi: a.float() - gi, g, g_i)

        losses, diffs = worker_vmap(loss_fn, one)(anchor, wkeys,
                                                  state["worker_g"])
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


@dataclasses.dataclass
class CMFilterEstimator(CompressedUploadBits, GradientEstimator):
    """Compressed momentum filtering: worker i keeps a momentum
    m_i = (1-β) g_i + β m_i and a server-mirrored reconstruction u_i, and
    uploads Q(m_i - u_i); both sides set u_i <- u_i + Q(m_i - u_i). The
    robust rule filters the u_i, and a server momentum η blends the result
    with the previous round's g. On the wire u_i is the payload's n-row
    base."""
    momentum: float = 0.9
    server_momentum: float = 0.0
    name = "cmfilter"
    rng = ("grad", "q", "attack", "agg")

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        z = _zeros_like_f32(params)
        return z, {"worker_m": tu.tree_broadcast_leading(z, cfg.n_workers),
                   "worker_u": tu.tree_broadcast_leading(z, cfg.n_workers)}

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None, trace=False):
        from repro_torch.core import wire

        n = cfg.n_workers
        beta = self.momentum
        eta = self.server_momentum
        wkeys = tu.per_worker_keys(keys["grad"], n)
        qkeys = tu.per_worker_keys(keys["q"], n,
                                   common=cfg.compressor.common_randomness)

        def one(b, kg, m_i, u_i):
            g, ln = grad_and_value(loss_fn)(params, b, kg)
            m_new = tu.tree_map(lambda gg, mm: (1 - beta) * gg.float()
                                + beta * mm, g, m_i)
            return ln, m_new, tu.tree_sub(m_new, u_i)

        losses, m_new, diffs = worker_vmap(loss_fn, one)(
            batch, wkeys, state["worker_m"], state["worker_u"])
        metrics = {"wire_bits": wire.tree_wire_bits(cfg.compressor, diffs)}
        if wire.wire_supported(cfg, diffs):
            cand = wire.pack_candidates(cfg.compressor, qkeys, diffs,
                                        base=state["worker_u"])
            u_new = tu.tree_add(state["worker_u"], wire.decoded_payload(cand))
        else:
            q = tu.compress_stacked(cfg.compressor, qkeys, diffs)
            cand = u_new = tu.tree_add(state["worker_u"], q)
        g_prev = state["g"]          # the previous round's g

        def finalize(agg):
            g = tu.tree_map(lambda a, gp: (1 - eta) * a.float()
                            + eta * gp.float(), agg, g_prev)
            return g, {"worker_m": m_new, "worker_u": u_new}

        return RoundOutput(loss=losses.mean(), cand=cand, finalize=finalize,
                           metrics=metrics)


def saga_indices(k_idx, m: int, b: int):
    """(..., b) table slots drawn without replacement: the first b of a
    permutation of the m slots, one per key of k_idx (..., 2)."""
    return R.permutation(k_idx, m)[..., :b]


def _rows(t, idx):
    """idx (n, b) broadcast over the trailing axes of t (n, m, ...)."""
    n, b = idx.shape
    return idx.reshape((n, b) + (1,) * (t.dim() - 2)).expand(
        (n, b) + tuple(t.shape[2:]))


def saga_update(table, table_mean, g_new, idx):
    """One leaf of every worker's SAGA step: table (n, m, ...), its mean
    (n, ...), the fresh gradients g_new (n, b, ...) at slots idx (n, b) ->
    (estimate mean_j[g_new - table[idx]] + table_mean, the table with
    g_new written at idx, its mean)."""
    i = _rows(table, idx)
    diff = g_new - torch.gather(table, 1, i)
    return (mean0(diff, 1) + table_mean, table.scatter(1, i, g_new),
            table_mean + xla_sum_rows(diff.unbind(1)) * (1.0 / table.shape[1]))


@dataclasses.dataclass
class SAGAEstimator(GradientEstimator):
    """SAGA over the stacked protocol: worker i keeps a per-sample gradient
    table over its slice of the anchor and the table's mean, and sends
    v_i = mean_j[∇f_{i,j}(x) - table_i[j]] + mean(table_i) over b slots j
    drawn without replacement. The tables are worker state and never on
    the wire; they need the same anchor every round (``RunSpec`` refuses
    ``task="lm"``). ``seed_batchable = False``: a vmap over seeds would
    stack the (n, m, d) tables once a seed."""
    batch_size: int = 16
    name = "saga"
    rng = ("grad", "attack", "agg")
    seed_batchable = False

    def init_extras(self, cfg, loss_fn, params, anchor, key):
        n = cfg.n_workers
        m = tu.leaves(anchor)[0].shape[1]      # samples per worker
        return tu.tree_zeros_like(params), {
            "worker_table": tu.tree_map(
                lambda p: torch.zeros((n, m) + tuple(p.shape),
                                      dtype=torch.float32, device=p.device),
                params),
            "worker_table_mean": tu.tree_broadcast_leading(
                _zeros_like_f32(params), n),
        }

    def round(self, cfg, loss_fn, state, params, old_params, batch, anchor,
              keys, sampled=None, trace=False):
        table = state["worker_table"]
        n, m = tu.leaves(table)[0].shape[:2]
        b = min(int(self.batch_size), m)
        wkeys = tu.per_worker_keys(keys["grad"], n)
        kk = R.split(wkeys, 2)                           # (n, 2, 2)
        k_idx, k_loss = kk[:, 0], kk[:, 1]
        idx = saga_indices(k_idx, m, b)                  # (n, b)

        # every worker's b samples as n·b batches of one sample
        samples = {k: torch.gather(a, 1, _rows(a, idx)).reshape(
            (n * b, 1) + tuple(a.shape[2:])) for k, a in anchor.items()}
        lkeys = k_loss[:, None].expand(n, b, 2).reshape(n * b, 2)

        def g_of(sample, kl):
            g, ln = grad_and_value(loss_fn)(params, sample, kl)
            return ln, g

        losses, g_new = worker_vmap(loss_fn, g_of)(samples, lkeys)
        v, tables, means = {}, {}, {}
        for k in sorted(table):
            gn = g_new[k].float().reshape((n, b) + tuple(g_new[k].shape[1:]))
            v[k], tables[k], means[k] = saga_update(
                table[k], state["worker_table_mean"][k], gn, idx)
        loss = losses.reshape(n, b).mean(1).mean()
        return RoundOutput(loss=loss, cand=v,
                           updates={"worker_table": tables,
                                    "worker_table_mean": means})


def _marina_factory(cfg, **kw):
    if cfg.agg_mode == "sparse_support":
        comp = cfg.compressor
        if not (comp.common_randomness and comp.ratio is not None):
            raise ValueError(
                "agg_mode='sparse_support' needs a common-randomness RandK "
                f"compressor, got {comp.name!r}")
        return MarinaSparseEstimator(**kw)
    return MarinaEstimator(**kw)


def _ef21_factory(cfg, **kw):
    if cfg.compressor.contractive_fn is None:
        raise ValueError(
            "byz_ef21 needs a contractive compressor (topk / sign / "
            "identity — Compressor.contractive_delta must be defined): the "
            "EF21 recursion contracts the error-feedback state, and "
            f"unbiasedness scaling breaks it; got {cfg.compressor.name!r}")
    return ByzEF21Estimator(**kw)


ESTIMATORS = {
    "marina": _marina_factory,
    "sgd": lambda cfg, **kw: SGDEstimator(momentum=kw.pop("momentum", 0.0),
                                          **kw),
    "sgdm": lambda cfg, **kw: SGDEstimator(momentum=kw.pop("momentum", 0.9),
                                           **kw),
    "csgd": lambda cfg, **kw: CSGDEstimator(**kw),
    "diana": lambda cfg, **kw: DianaEstimator(**kw),
    "mvr": lambda cfg, **kw: MVREstimator(**kw),
    "svrg": lambda cfg, **kw: SVRGEstimator(**kw),
    "byz_ef21": _ef21_factory,
    "cmfilter": lambda cfg, **kw: CMFilterEstimator(**kw),
    "saga": lambda cfg, **kw: SAGAEstimator(**kw),
}

# the traits of a method without a cfg in hand
ESTIMATOR_CLASSES = {
    "marina": MarinaEstimator,
    "sgd": SGDEstimator,
    "sgdm": SGDEstimator,
    "csgd": CSGDEstimator,
    "diana": DianaEstimator,
    "mvr": MVREstimator,
    "svrg": SVRGEstimator,
    "byz_ef21": ByzEF21Estimator,
    "cmfilter": CMFilterEstimator,
    "saga": SAGAEstimator,
}


def needs_contractive_compressor(name: str) -> bool:
    """Whether this method rejects unbiased-Q compressors (EF21 family)."""
    cls = ESTIMATOR_CLASSES.get(name)
    return bool(getattr(cls, "needs_contractive", False))


def streamable(name: str) -> bool:
    """Whether this method's candidates may be computed at dispatch time
    and buffered; unknown names answer False."""
    cls = ESTIMATOR_CLASSES.get(name)
    return False if cls is None else bool(getattr(cls, "streamable", False))


def seed_batchable(name: str) -> bool:
    """Whether cells of this method may run vmapped over seeds; unknown
    names answer False."""
    cls = ESTIMATOR_CLASSES.get(name)
    return False if cls is None else bool(getattr(cls, "seed_batchable",
                                                  True))


def get_estimator(name: str, cfg, **kw) -> GradientEstimator:
    if name not in ESTIMATORS:
        raise KeyError(f"unknown method {name!r}; known: {sorted(ESTIMATORS)}")
    return ESTIMATORS[name](cfg, **kw)
