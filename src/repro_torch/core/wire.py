"""The wire protocol layer: compressed payloads from worker to kernel
(port of ``repro/core/wire.py``): the sparse RandK and TopK wire, and the
dense int8, sign and bf16 wires.

Under ``agg_mode="pallas"`` MARINA's VR round and every Byz-EF21 round
hand the engine a ``WireCandidates`` payload instead of the dense
candidate tree; the robust-aggregation kernel rebuilds
``cand = base + decode(payload)`` per tile, so the dense (n, d)
candidates never exist in device memory. The base is MARINA's shared g^k
(one row) or Byz-EF21's per-worker g_i (n rows).

* ``pack_candidates``  — per (worker, leaf) packing on compress_tree's key
                         schedule (fold_in(worker_key, leaf_index)), so the
                         RandK and TopK supports and the int8 dither equal
                         the dense compressor's.
* ``decoded_payload``  — dense tree equal to compress_tree per worker.
* ``reconstruct``      — the dense candidate tree (base + decoded).
* ``measured_bits``    — the semantic bits of a packed payload, and
  ``tree_wire_bits``     their twin from static shapes.
* ``wire_stats``       — good-worker mean/std read from the wire: the sparse
                         wire with flat scatter-adds, never an (n, d)
                         scatter; the dense formats decoded elementwise.
* ``wire_message_phase`` — attack + aggregation over the wire, with the
                         fault guard's decode check.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch import random as R
from repro_torch.core import tree_utils as tu
from repro_torch.core.aggregators import xla_sum_rows
from repro_torch.core.attacks import fma_f32
from repro_torch.core.compressors import _MAX_UNITS
from repro_torch.kernels import quantize


@dataclasses.dataclass(frozen=True)
class WireCandidates:
    """A stacked candidate tree in wire form. ``payloads[j]`` is leaf j's
    packed dict (worker-stacked); ``base`` None or a tuple of (rows, d_j)
    bases; ``names`` the tree's sorted keys; ``dtypes`` the oracle
    candidate dtypes, ``src_dtypes`` the compressed leaves' own."""
    fmt: str
    n: int
    payloads: tuple
    base: Optional[tuple]
    names: tuple
    shapes: tuple
    dtypes: tuple
    src_dtypes: tuple


def _leaf_d(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def wire_supported(cfg, stacked=None) -> bool:
    """Whether (cfg, candidate tree) routes through the fused wire: the
    pallas backend, a kernel wire format, and RandK leaves inside the
    per-coordinate selection regime."""
    comp = getattr(cfg, "compressor", None)
    if comp is None or getattr(cfg, "agg_mode", None) != "pallas":
        return False
    fmt = comp.wire_format
    if fmt is None or fmt == "dense32" or comp.fallback_only:
        return False
    if fmt == "sparse" and stacked is not None:
        if any(_leaf_d(l.shape[1:]) > _MAX_UNITS for l in tu.leaves(stacked)):
            return False
    return True


def _pack_fn(compressor):
    """(key (n, 2), x (n, d)) -> the worker-stacked payload of a leaf."""
    fmt = compressor.wire_format
    if fmt == "sparse":
        # TopK is the contractive sparse operator, RandK the unbiased one
        return functools.partial(quantize.pack_sparse, ratio=compressor.ratio,
                                 topk=compressor.contractive_fn is not None)
    return quantize.PACK[fmt]


def pack_candidates(compressor, qkeys, stacked: dict, *, base=None,
                    base_shared: bool = False) -> WireCandidates:
    """Pack the stacked tree; leaf i of worker w packs under
    fold_in(qkeys[w], i), as compress_tree does."""
    names = tuple(sorted(stacked))
    n = stacked[names[0]].shape[0]
    fn = _pack_fn(compressor)
    base_leaves = tu.leaves(base) if base is not None else [None] * len(names)
    payloads, bases, shapes, dtypes, src_dtypes = [], [], [], [], []
    for i, name in enumerate(names):
        leaf = stacked[name]
        payloads.append(fn(R.fold_in(qkeys, i), leaf.reshape(n, -1)))
        shapes.append(tuple(leaf.shape[1:]))
        src_dtypes.append(leaf.dtype)
        b = base_leaves[i]
        if b is None:
            bases.append(None)
            dtypes.append(leaf.dtype)
        else:
            bases.append(b.reshape(1 if base_shared else n, -1))
            dtypes.append(torch.promote_types(b.dtype, leaf.dtype))
    return WireCandidates(
        fmt=compressor.wire_format, n=n, payloads=tuple(payloads),
        base=None if base is None else tuple(bases), names=names,
        shapes=tuple(shapes), dtypes=tuple(dtypes),
        src_dtypes=tuple(src_dtypes))


def decoded_payload(wc: WireCandidates) -> dict:
    """Stacked dense tree equal to compress_tree per worker."""
    return {name: quantize.decode(wc.fmt, p, _leaf_d(sh)).to(dt)
            .reshape((wc.n,) + sh)
            for name, p, sh, dt in zip(wc.names, wc.payloads, wc.shapes,
                                       wc.src_dtypes)}


def reconstruct(wc: WireCandidates) -> dict:
    """The dense candidate tree: decode -> candidate dtype -> + base ->
    candidate dtype."""
    out = {}
    for j, (name, p, sh, dt) in enumerate(zip(wc.names, wc.payloads,
                                              wc.shapes, wc.dtypes)):
        base = None if wc.base is None else wc.base[j]
        x = quantize.recon_rows(wc.fmt, p, _leaf_d(sh), base, dt).to(dt)
        out[name] = x.expand(wc.n, -1).reshape((wc.n,) + sh)
    return out


def wire_srcs(wc: WireCandidates) -> list:
    """Per-leaf ``quantize.WireSrc`` kernel inputs."""
    return [quantize.WireSrc(
        fmt=wc.fmt, n=wc.n, d=_leaf_d(sh),
        arrays=tuple((nm, a.reshape(wc.n, -1)) for nm, a in p.items()),
        base=None if wc.base is None else wc.base[j], cand_dtype=dt)
        for j, (p, sh, dt) in enumerate(zip(wc.payloads, wc.shapes,
                                            wc.dtypes))]


def _semantic_bits(fmt, d, *, k=None, vbits=32, nblocks=None) -> float:
    """Bits one worker's leaf payload carries: values at their packed
    precision, plus 32-bit indices, norms or scale. A sign is one bit
    (the int8 array is the device layout, not the wire's entropy)."""
    if fmt == "sparse":
        return k * (vbits + 32)
    if fmt == "int8":
        return 8 * d + 32 * nblocks
    if fmt == "sign":
        return d + 32
    if fmt == "bf16":
        return 16 * d
    raise ValueError(fmt)


def measured_bits(wc: WireCandidates) -> float:
    """Semantic wire bits per worker per round, read off the packed
    arrays (the k, block counts and value dtypes the kernels consume)."""
    total = 0.0
    for p, sh in zip(wc.payloads, wc.shapes):
        d = _leaf_d(sh)
        if wc.fmt == "sparse":
            total += _semantic_bits("sparse", d, k=p["vals"].shape[-1],
                                    vbits=p["vals"].element_size() * 8)
        elif wc.fmt == "int8":
            total += _semantic_bits("int8", d,
                                    nblocks=p["norms"].shape[-1])
        else:
            total += _semantic_bits(wc.fmt, d)
    return float(total)


def tree_wire_bits(compressor, stacked: dict) -> float:
    """What ``measured_bits(pack_candidates(...))`` returns, from static
    shapes alone, so that both backends report the same per-round
    ``wire_bits``; the theory accounting (``Compressor.tree_bits``) for a
    compressor without a kernel wire."""
    fmt = compressor.wire_format
    leaves = tu.leaves(stacked)
    dims = [_leaf_d(l.shape[1:]) for l in leaves]
    if fmt in (None, "dense32") or compressor.fallback_only:
        return compressor.tree_bits(dims)
    total = 0.0
    for leaf, d in zip(leaves, dims):
        if fmt == "sparse":
            total += _semantic_bits(
                "sparse", d, k=max(int(compressor.ratio * d), 1),
                vbits=leaf.element_size() * 8)
        elif fmt == "int8":
            total += _semantic_bits("int8", d,
                                    nblocks=-(-d // quantize.INT8_BLOCK))
        else:
            total += _semantic_bits(fmt, d)
    return float(total)


def wire_stats(wc: WireCandidates, good_mask, sanitize: bool = False):
    """Good-worker per-coordinate (mean, std) of the candidates, as
    per-leaf flat (d_j,) lists. A sparse float32 leaf takes a flat
    scatter-add for Σ w·q and gathered cross-terms for Σ w·(x - m)²; the
    dense formats (and a sparse leaf of another candidate dtype) decode
    elementwise (``quantize.recon_rows``) and take the masked mean and
    variance over the rows in XLA's row order (``xla_sum_rows``), each
    divided by the good count.

    ``sanitize`` (fault guard): the masked-out rows are zeroed first (the
    sparse wire's values and indices), since a zero weight does not
    neutralize a NaN value and a garbled index would scatter out of
    range."""
    g = good_mask.float()
    cnt = torch.clamp(g.sum(), min=1.0)
    w = g[:, None]
    means, stds = [], []
    for j, (p, sh, dt) in enumerate(zip(wc.payloads, wc.shapes, wc.dtypes)):
        d = _leaf_d(sh)
        base = None if wc.base is None else wc.base[j]
        if wc.fmt != "sparse" or dt != torch.float32:
            x = quantize.recon_rows(wc.fmt, p, d, base, dt).expand(wc.n, d)
            if sanitize:
                x = torch.where(w > 0.0, x, 0.0)
            m = xla_sum_rows(list((x * w).unbind(0))) / cnt
            if (wc.fmt == "int8" and base is None and dt == torch.float32
                    and not sanitize):
                # XLA fuses the decode's product into x - m
                prod, rcp = quantize.int8_parts(p, d)
                diff = fma_f32(prod, rcp, -m)
            else:
                diff = x - m[None]
            var = xla_sum_rows(list((diff.square() * w).unbind(0))) / cnt
            means.append(m)
            stds.append(_sqrt_f32(var))
            continue
        vals = p["vals"].float()                          # (n, k)
        idx = p["idx"].long()                             # (n, k)
        if sanitize:
            ok = good_mask[:, None]
            vals = torch.where(ok, vals, 0.0)
            idx = torch.where(ok, idx, 0)
        fi = idx.reshape(-1)
        qsum = _scatter_sum(d, fi, (w * vals).reshape(-1))
        if base is None:
            m = qsum / cnt
            s2 = _scatter_sum(d, fi, (w * vals * vals).reshape(-1))
            var = s2 / cnt - m.square()
        else:
            bf = base.float()                             # (rows, d)
            per_worker = bf.shape[0] == wc.n
            bmean = (bf * w).sum(0) / cnt if per_worker else bf[0]
            m = bmean + qsum / cnt
            db = bf - m[None]
            t1 = ((db.square() * w).sum(0) if per_worker
                  else cnt * db[0].square())
            bg = torch.gather(bf, 1, idx) if per_worker else bf[0][idx]
            mg = m[idx]
            cross = _scatter_sum(
                d, fi, (w * vals * (2.0 * (bg - mg) + vals)).reshape(-1))
            var = (t1 + cross) / cnt
        means.append(m)
        stds.append(_sqrt_f32(var))
    return means, stds


def _scatter_sum(d: int, fi, src):
    """(d,) float32 sums of ``src`` at the slots ``fi``, each slot's terms
    added from zero in their order in ``fi``, as the reference's
    scatter-add: ``index_put_`` with ``accumulate``, a sequential loop on
    the CPU and a sorted, ordered reduction on the card, where
    ``index_add``'s atomics would add a slot's terms in any order and a
    run would not repeat bit for bit."""
    return torch.zeros(d, dtype=torch.float32, device=src.device).index_put_(
        (fi,), src, accumulate=True)


def _sqrt_f32(var):
    """sqrt(max(var, 0)) correctly rounded (``torch.sqrt`` on the CPU is
    not): taken in float64 and rounded once."""
    return torch.sqrt(torch.clamp(var, min=0.0).double()).float()


def wire_message_phase(cfg, attack_key, agg_key, wc: WireCandidates,
                       return_info: bool = False):
    """Omniscient attack + robust aggregation over a wire payload: the
    kernel-fusable attacks ride into the kernel; other backends, and an
    attack without a load form (RN), reconstruct densely.

    ``cfg.fault_guard`` adds the fail-closed decode guard: rows whose
    payload does not decode safely (``faults.guard.payload_valid``:
    non-finite floats, sparse indices outside [0, d)) get zero weight and
    stay out of the attack's statistics; the kernels select-zero them
    after reconstruction. Paths that materialize the attacked candidates
    also reject rows the attack left non-finite.

    ``return_info`` (the telemetry twin) returns ``(agg, info, valid)``:
    the rules' intermediates and the final (n,) validity (None
    unguarded). The aggregate comes from the same calls either way."""
    from repro_torch.core import engine
    from repro_torch.core.sharded_agg import (
        AttackCtx, tree_aggregate_pallas, tree_aggregate_pallas_wire)
    from repro_torch.faults import guard as fguard
    guard = cfg.fault_guard
    valid = fguard.payload_valid(wc) if guard else None

    def ret(out):
        return (*out, valid) if return_info else out

    if cfg.agg_mode != "pallas":
        sent = engine.apply_attack(cfg, attack_key, reconstruct(wc),
                                   stats_valid=valid)
        if guard:
            valid = valid & fguard.finite_row_mask(sent)
        return ret(engine.aggregate(cfg, agg_key, sent, valid=valid,
                                    return_info=return_info))
    if cfg.n_byz == 0 or cfg.attack.name in ("NA", "LF"):
        return ret(tree_aggregate_pallas_wire(cfg, agg_key, wc, valid=valid,
                                              return_info=return_info))
    if cfg.attack.coord_apply is None:
        # an attack the load cannot apply (RN): the dense candidates, the
        # attack on them, the dense kernels
        sent = engine.apply_attack(cfg, attack_key, reconstruct(wc),
                                   stats_valid=valid)
        if guard:
            valid = valid & fguard.finite_row_mask(sent)
        return ret(tree_aggregate_pallas(cfg, agg_key, sent, valid=valid,
                                         return_info=return_info))
    mask = cfg.byz_mask(next(iter(wc.payloads[0].values())).device)
    means = stds = None
    if cfg.attack.needs_mean or cfg.attack.needs_std:
        good = ~mask if valid is None else ~mask & valid
        means, stds = wire_stats(wc, good, sanitize=guard)
        if not cfg.attack.needs_std:
            stds = None
    ctx = AttackCtx(fn=cfg.attack.coord_apply, mask=mask, means=means,
                    stds=stds)
    return ret(tree_aggregate_pallas_wire(cfg, agg_key, wc, attack_ctx=ctx,
                                          valid=valid,
                                          return_info=return_info))
