"""The kernel aggregation backend, ``agg_mode="pallas"`` (port of the
unguarded, n <= 64 part of ``repro/core/sharded_agg.py``).

Every rule runs on the kernels: mean / cm / tm on the robust-aggregation
kernel, RFA and Krum through the ``norm_agg`` drivers, whose distances
stay global across leaves. Leaves share one bucketing permutation,
carried as the (nb, n) ``bucket_matrix``; leaves narrower than
``SMALL_LEAF_D`` pack into one (n, D) segment so they share a launch; a
kernel-fusable attack rides into the kernels' load so the attacked stack
is never written to device memory. The ``all_to_all`` backend, staleness
weights, the fault guard, telemetry and n > 64 workers are not ported yet
(ROADMAP queue 1, items 7, 8, 10, 11).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as R
from repro_torch.core import tree_utils as tu
from repro_torch.core.aggregators import COORD_KERNEL_RULE, MAX_FUSED_WORKERS
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


def _check_supported(n):
    if n > MAX_FUSED_WORKERS:
        raise NotImplementedError(
            f"n={n} > {MAX_FUSED_WORKERS} workers is not ported yet "
            "(ROADMAP queue 1, item 7)")


def _bucket_operator(agg, key, n, device):
    if agg.bucket_size > 1 and agg.rule != "mean":
        perm = R.permutation(key, n)
        return norm_agg.bucket_matrix(perm, n, agg.bucket_size).to(device)
    return None


def _rule_outs(agg, srcs, w_mat, attack_fn, mask, means, stds):
    """The rule over kernel inputs ``srcs`` (dense segments or WireSrcs):
    one (d_j,) aggregate per input."""
    if agg.rule == "rfa":
        return norm_agg.rfa_segments(
            srcs, w_mat=w_mat, mask=mask, means=means, stds=stds,
            attack=attack_fn, iters=agg.iters, eps=agg.eps)
    if agg.rule == "krum":
        return norm_agg.krum_segments(
            srcs, w_mat=w_mat, mask=mask, means=means, stds=stds,
            attack=attack_fn, n_byz=agg.n_byz)
    rule = COORD_KERNEL_RULE[agg.rule]
    return [robust_agg(src, w_mat, mask, mu, sd, rule=rule, trim=agg.trim,
                       attack=attack_fn)
            for src, mu, sd in zip(srcs, means, stds)]


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


def tree_aggregate_pallas(cfg, key, sent: dict, attack_ctx=None) -> dict:
    """Aggregate the stacked candidate tree through the kernels, leaf-wise
    by segment, with one shared bucket operator."""
    agg = cfg.aggregator
    leaves = tu.leaves(sent)
    n = leaves[0].shape[0]
    _check_supported(n)
    w_mat = _bucket_operator(agg, key, n, leaves[0].device)
    attack_fn = mask = None
    ctx = None
    if attack_ctx is not None:
        attack_fn, mask = attack_ctx.fn, attack_ctx.mask
        ctx = AttackCtx(
            attack_ctx.fn, attack_ctx.mask,
            None if attack_ctx.means is None else tu.leaves(attack_ctx.means),
            None if attack_ctx.stds is None else tu.leaves(attack_ctx.stds))
    segs, means, stds, splits = _segments(leaves, ctx)
    outs = _rule_outs(agg, segs, w_mat, attack_fn, mask, means, stds)
    tree_out = [None] * len(leaves)
    for out, split in zip(outs, splits):
        for i, off, sz in split:
            tree_out[i] = (out[off:off + sz].reshape(leaves[i].shape[1:])
                           .to(leaves[i].dtype))
    return tu.unflatten(sent, tree_out)


def tree_aggregate_pallas_wire(cfg, key, wc, attack_ctx=None) -> dict:
    """Wire twin of ``tree_aggregate_pallas``: each leaf launches the
    kernels on its ``quantize.WireSrc`` (no packing: payloads do not
    concatenate); ``attack_ctx`` carries per-leaf flat stat lists."""
    from repro_torch.core import wire as W
    agg = cfg.aggregator
    n = wc.n
    _check_supported(n)
    srcs = W.wire_srcs(wc)
    w_mat = _bucket_operator(agg, key, n, srcs[0].device)
    attack_fn = mask = None
    means = stds = [None] * len(srcs)
    if attack_ctx is not None:
        attack_fn, mask = attack_ctx.fn, attack_ctx.mask
        if attack_ctx.means is not None:
            means = list(attack_ctx.means)
        if attack_ctx.stds is not None:
            stds = list(attack_ctx.stds)
    outs = _rule_outs(agg, srcs, w_mat, attack_fn, mask, means, stds)
    return {name: out.reshape(sh).to(dt)
            for name, out, sh, dt in zip(wc.names, outs, wc.shapes,
                                         wc.dtypes)}
