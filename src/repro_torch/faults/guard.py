"""Graceful-degradation primitives: validity masks and masked bucketing
(port of ``repro/faults/guard.py``).

The guard contract: a worker whose message is structurally bad —
non-finite candidate coordinates, non-finite wire floats, sparse indices
outside [0, d) — gets zero aggregation weight and counts toward the δ
budget, as if the Byzantine set had absorbed it. Structurally valid
garbage (a replayed zero update) passes the guard by design: arbitrary
finite deviation is what the robust aggregators are for.

Everything here is plain PyTorch on the tensors' own device, with no host
read, so the plain masked rules and the kernels consume the same
``valid`` vector and the same renormalized bucket operator.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import tree_utils as tu


def finite_row_mask(tree: dict):
    """(n,) bool: worker i's row is finite in every leaf coordinate.
    Integer leaves are always finite."""
    leaves = tu.leaves(tree)
    n = leaves[0].shape[0]
    m = torch.ones(n, dtype=torch.bool, device=leaves[0].device)
    for leaf in leaves:
        if not leaf.is_floating_point():
            continue
        m = m & torch.isfinite(leaf.reshape(n, -1)).all(1)
    return m


def payload_valid(wc):
    """(n,) bool: worker i's wire payload decodes safely — every float
    payload array finite and every sparse index inside [0, d). A False
    row is rejected: zero weight, never reconstructed into the aggregate."""
    first = wc.payloads[0][next(iter(wc.payloads[0]))]
    m = torch.ones(wc.n, dtype=torch.bool, device=first.device)
    for payload, shape in zip(wc.payloads, wc.shapes):
        d = math.prod(shape) if shape else 1
        for name, arr in payload.items():
            a = arr.reshape(wc.n, -1)
            if a.is_floating_point():
                m = m & torch.isfinite(a).all(1)
            elif name == "idx":
                m = m & ((a >= 0) & (a < d)).all(1)
    return m


def masked_bucket_matrix(perm, n: int, s: int, valid):
    """Renormalized (nb, n) bucket-mean operator over the valid members
    only, and the (nb,) bucket-validity mask (a bucket with no valid
    member is itself rejected downstream). Bucket b owns positions
    [b·s, (b+1)·s) of the permutation."""
    nb = -(-n // s)
    bucket_of = torch.arange(n, device=perm.device) // s
    member = torch.zeros(nb, n, dtype=torch.float32, device=perm.device)
    member[bucket_of, perm.long()] = 1.0
    w = member * valid.float()[None, :]
    cnt = w.sum(1, keepdim=True)
    bvalid = cnt[:, 0] > 0.0
    return w / torch.clamp(cnt, min=1.0), bvalid


def identity_bucket_matrix(n: int, valid):
    """The s = 1 case: diag(valid), with bucket validity = worker
    validity."""
    w = (torch.eye(n, dtype=torch.float32, device=valid.device)
         * valid.float()[None, :])
    return w, valid


def masked_sort_fill(x, valid, fill=float("inf")):
    """Rows with valid = False become ``fill``, so a sort pushes them past
    every real entry."""
    v = valid.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(v, x, torch.tensor(fill, dtype=x.dtype,
                                          device=x.device))
