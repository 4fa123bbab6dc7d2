"""RoundTrace: per-round telemetry of the aggregator's decisions (port of
``repro/obs/trace.py``).

``traced_message_phase`` is ``engine.message_phase(..., trace=True)``:
the same code path and so the same aggregate, bit for bit. The backend
calls take ``return_info`` (``Aggregator.tree_traced`` /
``tree_masked(..., return_info=True)`` on gspmd,
``tree_aggregate_pallas(..., return_info=True)`` on the kernels, whose
drivers issue the launches of an untraced round), and ``_build_trace``
makes a ``RoundTrace`` after them from what those calls hold and from the
attacked stack ``sent``, materialized for the trace alone:

* ``influence``      — (n,) each worker's effective weight in the
                       aggregate: the rule's weights pushed back through
                       the bucket operator. Sums to about 1.
* ``dist_to_agg``    — (n,) distance of each sent vector to the aggregate.
* ``bucket_weights`` — (m,) the rule's weight of each bucketed row:
                       uniform for mean, the last Weiszfeld weights for
                       RFA, the selection one-hot for Krum, the selection
                       fractions averaged over coordinates for cm / tm
                       (ranks of ranks of the bucketed stack, ties in
                       ``jnp.argsort``'s stable order).
* ``byz_mask``       — (n,) ground truth: the first n_byz workers, or the
                       service's per-fire mask.
* ``krum_scores`` / ``krum_selected`` / ``rfa_weights`` / ``rfa_residual``
                     — rule intermediates (None for the other rules).
                       RFA's distances to its output are taken here from
                       the bucketed stack; the reference's driver spends
                       one more kernel pass on them.
* ``fault_mask``     — (n,) the rows the fault plan hit this round,
                       recomputed from (plan, attack key); None without a
                       plan.
* ``guard_valid``    — (n,) the fail-closed guard's verdict; None with the
                       guard off.
* ``sampled_mask``   — (n,) this round's cohort; None at full
                       participation.

The cohort comes in as an argument, as the engine passes it, and so do
the streaming service's per-fire byzantine mask (over the buffered
entries, in place of the first n_byz workers) and staleness weights
(``traced_ingest_message_phase``): the rule saw the scaled rows, so its
weights are pushed back through the scale, and the influence sums to the
weighted rows' total rather than to 1. Nothing of the trace flows into
the aggregate.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import random as R
from repro_torch.core import engine
from repro_torch.core import tree_utils as tu


@dataclasses.dataclass(frozen=True)
class RoundTrace:
    """One round's aggregator decisions (device tensors until
    ``to_host``)."""
    rule: str
    influence: Any                 # (n,) float32
    dist_to_agg: Any               # (n,) float32
    bucket_weights: Any            # (m,) float32
    byz_mask: Any                  # (n,) bool
    krum_scores: Any = None        # (m,) float32 | None
    krum_selected: Any = None      # () int | None
    rfa_weights: Any = None        # (m,) float32 | None
    rfa_residual: Any = None       # () float32 | None
    fault_mask: Any = None         # (n,) bool | None
    guard_valid: Any = None        # (n,) bool | None
    sampled_mask: Any = None       # (n,) bool | None


_RT_DATA = ("influence", "dist_to_agg", "bucket_weights", "byz_mask",
            "krum_scores", "krum_selected", "rfa_weights", "rfa_residual",
            "fault_mask", "guard_valid", "sampled_mask")


def to_host(rt: RoundTrace) -> dict:
    """The trace as a JSON-ready dict: scalars and lists, None fields
    dropped. The one host read of a traced round."""
    out = {"rule": rt.rule}
    for f in _RT_DATA:
        v = getattr(rt, f)
        if v is None:
            continue
        a = torch.as_tensor(v).detach().cpu()
        if a.dim() == 0:
            out[f] = a.item()
        elif a.dtype == torch.bool:
            out[f] = [bool(x) for x in a.tolist()]
        else:
            out[f] = [float(x) for x in a.tolist()]
    return out


def traced_message_phase(cfg, attack_key, agg_key, cand, sampled=None):
    """``engine.message_phase`` with ``trace=True``: ``(agg, RoundTrace)``,
    ``agg`` equal bit for bit to the untraced phase's, since it is the same
    code path. ``sampled`` is the round's cohort."""
    return engine.message_phase(cfg, attack_key, agg_key, cand, sampled,
                                trace=True)


def traced_ingest_message_phase(cfg, attack_key, agg_key, cand, *,
                                byz_mask=None, weights=None):
    """``engine.ingest_message_phase`` with ``trace=True``: ``(agg,
    RoundTrace)``, ``agg`` equal bit for bit to the untraced phase's."""
    return engine.ingest_message_phase(cfg, attack_key, agg_key, cand,
                                       byz_mask=byz_mask, weights=weights,
                                       trace=True)


def _bucket_rows(w_b, x):
    """(m, n) W @ (n, D) x as the reference's compiled dot takes it: one
    fused multiply-add a row, in row order, for every bucket at once (the
    cm / tm ranks read these values, so they must tie where XLA's do)."""
    from repro_torch.core.attacks import fma_f32
    acc = torch.zeros(w_b.shape[0], x.shape[1], dtype=torch.float32,
                      device=x.device)
    for i in range(x.shape[0]):
        acc = fma_f32(w_b[:, i, None], x[i][None, :], acc)
    return acc


def _build_trace(cfg, agg_key, sent, agg, *, info, valid=None,
                 fault_mask=None, sampled=None, record_guard=True,
                 byz_mask=None, weights=None) -> RoundTrace:
    """The RoundTrace from the backend's intermediates and the attacked
    stack, in float32, diagnostics only. ``valid`` select-zeroes the
    rejected rows before any reduction (0·NaN is NaN) and swaps in the
    masked bucket operator, so rejected rows read zero influence and a
    finite distance. The bucketing permutation is ``info["perm"]`` or,
    where the kernels held the operator, recomputed from ``agg_key``.
    ``weights`` (the service's staleness scale) scale the rows the rule
    saw and the influence; ``byz_mask`` is the ground truth where given.
    """
    from repro_torch.xla_math import xla_sum_lanes
    from repro_torch.faults.guard import masked_bucket_matrix
    from repro_torch.kernels.norm_agg import bucket_matrix
    agg_obj = cfg.aggregator
    leaves = tu.leaves(sent)
    n = leaves[0].shape[0]
    dev = leaves[0].device
    x = torch.cat([a.reshape(n, -1).float() for a in leaves], dim=1)
    if valid is not None:
        x = torch.where(valid[:, None], x, torch.zeros((), device=dev))
    w_row = None if weights is None else weights.float().to(dev)
    xs = x if w_row is None else x * w_row[:, None]

    w_b = None
    if agg_obj.bucket_size > 1 and agg_obj.rule != "mean":
        perm = info.get("perm")
        if perm is None:
            perm = R.permutation(agg_key, n).to(dev)
        if valid is not None:
            w_b, _ = masked_bucket_matrix(perm, n, agg_obj.bucket_size,
                                          valid)
        else:
            w_b = bucket_matrix(perm, n, agg_obj.bucket_size)
    m = n if w_b is None else w_b.shape[0]
    agg_flat = torch.cat([a.reshape(-1).float() for a in tu.leaves(agg)])

    rule = agg_obj.rule
    krum_scores = krum_selected = rfa_weights = rfa_residual = None
    if rule == "mean":
        bw = torch.full((m,), 1.0 / m, dtype=torch.float32, device=dev)
    elif rule in ("cm", "tm"):
        y = xs if w_b is None else _bucket_rows(w_b, xs)
        r = torch.argsort(torch.argsort(y, dim=0, stable=True), dim=0,
                          stable=True)
        if rule == "cm":
            if m % 2:
                sel = (r == m // 2).float()
            else:
                sel = 0.5 * ((r == m // 2 - 1) | (r == m // 2)).float()
        else:
            t = min(agg_obj.trim, (m - 1) // 2)
            sel = ((r >= t) & (r < m - t)).float() / (m - 2 * t)
        # the mean over coordinates as jnp.mean compiles: the sum in XLA's
        # lane order times the rounded 1/D
        rcp = torch.ones((), dtype=torch.float32) / sel.shape[1]
        bw = xla_sum_lanes(sel) * rcp.to(dev)
    elif rule == "rfa":
        bw = rfa_weights = info["bucket_weights"]
        sq = info.get("rfa_sq")
        if sq is None:
            y = xs if w_b is None else w_b @ xs
            sq = ((y - agg_flat[None]) ** 2).sum(1)
        rfa_residual = torch.sqrt(sq + agg_obj.eps).mean()
    else:                            # krum
        bw = info["bucket_weights"]
        krum_scores = info["krum_scores"]
        krum_selected = info["krum_selected"]

    infl = bw if w_b is None else bw @ w_b
    if w_row is not None:
        infl = infl * w_row
    if valid is not None:
        infl = torch.where(valid, infl, torch.zeros((), device=dev))
    dist = torch.sqrt(((x - agg_flat[None]) ** 2).sum(1))
    mask = byz_mask
    if mask is None:
        mask = (cfg.byz_mask(dev) if cfg.n_byz
                else torch.zeros(n, dtype=torch.bool, device=dev))
    return RoundTrace(rule=rule, influence=infl, dist_to_agg=dist,
                      bucket_weights=bw, byz_mask=mask,
                      krum_scores=krum_scores, krum_selected=krum_selected,
                      rfa_weights=rfa_weights, rfa_residual=rfa_residual,
                      fault_mask=fault_mask,
                      guard_valid=valid if record_guard else None,
                      sampled_mask=sampled)
