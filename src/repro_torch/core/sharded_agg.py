"""The kernel aggregation backend, ``agg_mode="pallas"`` (port of the
kernel part of ``repro/core/sharded_agg.py``).

Every rule runs on the kernels: mean / cm / tm on the robust-aggregation
kernel, RFA and Krum through the ``norm_agg`` drivers, whose distances
stay global across leaves. Leaves share one bucketing permutation,
carried as the (nb, n) ``bucket_matrix``; leaves narrower than
``SMALL_LEAF_D`` pack into one (n, D) segment so they share a launch; a
kernel-fusable attack rides into the kernels' load so the attacked stack
is never written to device memory.

Above ``MAX_FUSED_WORKERS`` workers the fused kernels no longer hold the
worker axis, and rounds take the giant-n tier (``_tree_aggregate_large_n``):
attack and Alg. 2 bucketing first, in plain PyTorch, leaf by leaf; then
the coordinate rules in plain PyTorch, and RFA / Krum on the fused drivers
when the bucketed rows fit under ``MAX_FUSED_WORKERS``, else on the
blocked ones. Wire rounds at that size are reconstructed densely first.

``valid`` ((n,) bool: the fault guard's finite rows, or the sampled
cohort under partial participation) switches every rule to its masked
twin: the kernels select-zero invalid rows in their load, bucketing uses
``faults.guard.masked_bucket_matrix`` (each bucket renormalized over its
valid members), and the rules track the (m,) bucket validity ``bvalid``.
The giant-n tier zeroes the rows before bucketing and hands ``bvalid`` to
the drivers.

``weights`` ((n,) float32: the streaming service's staleness weights,
``engine.ingest_message_phase``) scale each sent row after the attack and
the guard's select and before bucketing. On the fused kernels the scale
rides in the operator W = W_bucket · diag(w) (W = diag(w), m = n, where
nothing is bucketed), so the scaled stack is never materialized; each
entry of W is one product, as the reference's ``w_mat @ diag(w)`` gives
it. The giant-n tier scales its flat rows. ``Aggregator.tree`` over the
scaled candidates is the reference.

``return_info=True`` (the telemetry twin, ``obs.trace``) returns
``(tree, info)``: the RFA / Krum drivers' own intermediates (see
``kernels.norm_agg``), ``{}`` for the coordinate rules, from the same
launches as ``return_info=False``.

The ``all_to_all`` backend is not ported yet (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as R
from repro_torch.core import aggregators as A
from repro_torch.core import tree_utils as tu
from repro_torch.core.aggregators import COORD_KERNEL_RULE, MAX_FUSED_WORKERS
from repro_torch.faults.guard import masked_bucket_matrix
from repro_torch.kernels import norm_agg
from repro_torch.kernels.robust_agg import robust_agg

# leaves narrower than this share one packed launch
SMALL_LEAF_D = 1024


@dataclasses.dataclass(frozen=True)
class AttackCtx:
    """Fused-attack inputs: the CoordAttack, the (n,) byzantine mask and
    the good workers' per-coordinate mean/std (trees on the dense path,
    per-leaf flat lists on the wire path; None when unread)."""
    fn: object
    mask: object
    means: object = None
    stds: object = None


def _bucket_operator(agg, key, n, device, valid=None, weights=None):
    """(W, bvalid): the (nb, n) bucket operator (None without bucketing)
    and the bucket validity (None unguarded). Under ``valid`` W is the
    masked operator, or, without bucketing, bvalid is ``valid`` itself.
    ``weights`` (n,) scale W's columns: W · diag(w), or diag(w) where
    nothing is bucketed."""
    bucketed = agg.bucket_size > 1 and agg.rule != "mean"
    w_mat, bvalid = None, valid
    if bucketed:
        perm = R.permutation(key, n).to(device)
        if valid is None:
            w_mat = norm_agg.bucket_matrix(perm, n, agg.bucket_size)
        else:
            w_mat, bvalid = masked_bucket_matrix(perm, n, agg.bucket_size,
                                                 valid)
    if weights is not None:
        w = weights.to(device=device, dtype=torch.float32)
        w_mat = torch.diag(w) if w_mat is None else w_mat * w[None, :]
    return w_mat, bvalid


def _rule_outs(agg, srcs, w_mat, attack_fn, mask, means, stds, valid=None,
               bvalid=None):
    """The rule over kernel inputs ``srcs`` (dense segments or WireSrcs):
    (one (d_j,) aggregate per input, the drivers' info)."""
    if agg.rule == "rfa":
        return norm_agg.rfa_segments(
            srcs, w_mat=w_mat, mask=mask, means=means, stds=stds,
            attack=attack_fn, iters=agg.iters, eps=agg.eps, valid=valid,
            bvalid=bvalid, return_info=True)
    if agg.rule == "krum":
        return norm_agg.krum_segments(
            srcs, w_mat=w_mat, mask=mask, means=means, stds=stds,
            attack=attack_fn, n_byz=agg.n_byz, valid=valid, bvalid=bvalid,
            return_info=True)
    rule = COORD_KERNEL_RULE[agg.rule]
    return [robust_agg(src, w_mat, mask, mu, sd, valid, bvalid, rule=rule,
                       trim=agg.trim, attack=attack_fn)
            for src, mu, sd in zip(srcs, means, stds)], {}


def _segments(leaves, attack_ctx):
    """Kernel launch units: (segs, means, stds, splits). Small leaves pack
    into one (n, sum d_j) segment (with their stats packed alike); each
    other leaf is its own (n, d_j) segment. splits[j] maps segment j back
    to [(leaf_index, offset, size)]."""
    n = leaves[0].shape[0]
    m_leaves = (attack_ctx.means if attack_ctx is not None
                and attack_ctx.means is not None else [None] * len(leaves))
    s_leaves = (attack_ctx.stds if attack_ctx is not None
                and attack_ctx.stds is not None else [None] * len(leaves))
    small = [i for i, x in enumerate(leaves) if x[0].numel() < SMALL_LEAF_D]
    segs, means, stds, splits = [], [], [], []
    packed = set()
    if len(small) >= 2:
        segs.append(torch.cat([leaves[i].reshape(n, -1).float()
                               for i in small], dim=1))
        for stats, dst in ((m_leaves, means), (s_leaves, stds)):
            dst.append(None if stats[small[0]] is None else torch.cat(
                [stats[i].reshape(-1).float() for i in small]))
        off, sp = 0, []
        for i in small:
            sp.append((i, off, leaves[i][0].numel()))
            off += leaves[i][0].numel()
        splits.append(sp)
        packed = set(small)
    for i, x in enumerate(leaves):
        if i in packed:
            continue
        segs.append(x.reshape(n, -1).float().contiguous())
        means.append(None if m_leaves[i] is None
                     else m_leaves[i].reshape(-1).float().contiguous())
        stds.append(None if s_leaves[i] is None
                    else s_leaves[i].reshape(-1).float().contiguous())
        splits.append([(i, 0, x[0].numel())])
    return segs, means, stds, splits


def _materialize_attack_flat(flats, dtypes, attack_ctx):
    """Plain twin of the kernels' prologue for the giant-n tier: the
    attack, a round trip through each leaf's candidate dtype, the mask
    select, on flat (n, d_j) float32 views. Coordinate-wise, so the same
    values the fused kernels would inject."""
    if attack_ctx is None or attack_ctx.fn is None or attack_ctx.mask is None:
        return flats
    n = flats[0].shape[0]
    m_l = (tu.leaves(attack_ctx.means) if attack_ctx.means is not None
           else [None] * len(flats))
    s_l = (tu.leaves(attack_ctx.stds) if attack_ctx.stds is not None
           else [None] * len(flats))
    keep = attack_ctx.mask.reshape(n, 1)
    out = []
    for xf, mu, sd, dt in zip(flats, m_l, s_l, dtypes):
        muf = None if mu is None else mu.reshape(1, -1).float()
        sdf = None if sd is None else sd.reshape(1, -1).float()
        v = attack_ctx.fn(xf, muf, sdf).to(dt).float()
        out.append(torch.where(keep, v, xf))
    return out


def _tree_aggregate_large_n(cfg, key, sent: dict, attack_ctx=None,
                            valid=None, weights=None):
    """Giant-n tier of ``tree_aggregate_pallas`` (more than
    ``MAX_FUSED_WORKERS`` workers): bucket first, so that no kernel holds
    the whole worker axis, then run the rule on the m bucketed rows of
    each leaf (module docstring). ``Aggregator.tree`` (``tree_masked``
    under ``valid``) over the attacked (and ``weights``-scaled)
    candidates is its reference. -> (tree, the drivers' info)."""
    agg = cfg.aggregator
    leaves = tu.leaves(sent)
    n = leaves[0].shape[0]
    flats = [a.reshape(n, -1).float() for a in leaves]
    flats = _materialize_attack_flat(flats, [a.dtype for a in leaves],
                                     attack_ctx)
    if valid is not None:
        # select-zero, never multiply (0·NaN = NaN)
        flats = [torch.where(valid[:, None], xf, 0.0) for xf in flats]
    if weights is not None:
        w = weights.float().reshape(n, 1)
        flats = [xf * w for xf in flats]
    bvalid = valid
    if agg.bucket_size > 1 and agg.rule != "mean":
        perm = R.permutation(key, n)
        if valid is None:
            flats = [A._bucketize_perm(xf, perm, agg.bucket_size)
                     for xf in flats]
        else:
            w_mat, bvalid = masked_bucket_matrix(perm, n, agg.bucket_size,
                                                 valid)
            flats = [w_mat @ xf for xf in flats]
    flats = [xf.contiguous() for xf in flats]
    m = flats[0].shape[0]
    info = {}
    if agg.rule in COORD_KERNEL_RULE:
        outs = [agg._rule(xf) if bvalid is None
                else agg._masked_rule(xf, bvalid) for xf in flats]
    elif agg.rule == "rfa":
        driver = (norm_agg.rfa_segments if m <= MAX_FUSED_WORKERS
                  else norm_agg.rfa_segments_blocked)
        outs, info = driver(flats, iters=agg.iters, eps=agg.eps,
                            bvalid=bvalid, return_info=True)
    else:
        driver = (norm_agg.krum_segments if m <= MAX_FUSED_WORKERS
                  else norm_agg.krum_segments_blocked)
        outs, info = driver(flats, n_byz=agg.n_byz, bvalid=bvalid,
                            return_info=True)
    return tu.unflatten(sent, [o.reshape(a.shape[1:]).to(a.dtype)
                               for o, a in zip(outs, leaves)]), info


def tree_aggregate_pallas(cfg, key, sent: dict, attack_ctx=None,
                          valid=None, return_info: bool = False,
                          weights=None):
    """Aggregate the stacked candidate tree through the kernels, leaf-wise
    by segment, with one shared bucket operator; more than
    ``MAX_FUSED_WORKERS`` workers take the giant-n tier. ``valid``,
    ``return_info`` and ``weights`` as in the module docstring."""
    agg = cfg.aggregator
    leaves = tu.leaves(sent)
    n = leaves[0].shape[0]
    if n > MAX_FUSED_WORKERS:
        tree, info = _tree_aggregate_large_n(cfg, key, sent, attack_ctx,
                                             valid, weights)
        return (tree, info) if return_info else tree
    w_mat, bvalid = _bucket_operator(agg, key, n, leaves[0].device, valid,
                                     weights)
    attack_fn = mask = None
    ctx = None
    if attack_ctx is not None:
        attack_fn, mask = attack_ctx.fn, attack_ctx.mask
        ctx = AttackCtx(
            attack_ctx.fn, attack_ctx.mask,
            None if attack_ctx.means is None else tu.leaves(attack_ctx.means),
            None if attack_ctx.stds is None else tu.leaves(attack_ctx.stds))
    segs, means, stds, splits = _segments(leaves, ctx)
    outs, info = _rule_outs(agg, segs, w_mat, attack_fn, mask, means, stds,
                            valid, bvalid)
    tree_out = [None] * len(leaves)
    for out, split in zip(outs, splits):
        for i, off, sz in split:
            tree_out[i] = (out[off:off + sz].reshape(leaves[i].shape[1:])
                           .to(leaves[i].dtype))
    tree = tu.unflatten(sent, tree_out)
    return (tree, info) if return_info else tree


def tree_aggregate_pallas_wire(cfg, key, wc, attack_ctx=None,
                               valid=None, return_info: bool = False):
    """Wire twin of ``tree_aggregate_pallas``: each leaf launches the
    kernels on its ``quantize.WireSrc`` (no packing: payloads do not
    concatenate); ``attack_ctx`` carries per-leaf flat stat lists. More
    than ``MAX_FUSED_WORKERS`` workers reconstruct the dense candidates
    once and take the giant-n tier, with the stats reshaped into trees."""
    from repro_torch.core import wire as W
    agg = cfg.aggregator
    n = wc.n
    if n > MAX_FUSED_WORKERS:
        ctx = attack_ctx
        if ctx is not None:
            def unflat(stats):
                return None if stats is None else {
                    name: st.reshape(sh)
                    for name, st, sh in zip(wc.names, stats, wc.shapes)}
            ctx = AttackCtx(ctx.fn, ctx.mask, unflat(ctx.means),
                            unflat(ctx.stds))
        tree, info = _tree_aggregate_large_n(cfg, key, W.reconstruct(wc),
                                             ctx, valid)
        return (tree, info) if return_info else tree
    srcs = W.wire_srcs(wc)
    w_mat, bvalid = _bucket_operator(agg, key, n, srcs[0].device, valid)
    attack_fn = mask = None
    means = stds = [None] * len(srcs)
    if attack_ctx is not None:
        attack_fn, mask = attack_ctx.fn, attack_ctx.mask
        if attack_ctx.means is not None:
            means = list(attack_ctx.means)
        if attack_ctx.stds is not None:
            stds = list(attack_ctx.stds)
    outs, info = _rule_outs(agg, srcs, w_mat, attack_fn, mask, means, stds,
                            valid, bvalid)
    tree = {name: out.reshape(sh).to(dt)
            for name, out, sh, dt in zip(wc.names, outs, wc.shapes,
                                         wc.dtypes)}
    return (tree, info) if return_info else tree
