"""Plain PyTorch oracles for the kernels (port of ``repro/kernels/ref.py``).

The norm-based oracles (``rfa_ref``, ``krum_ref``, ``pair_sqdists_ref``)
delegate to ``core.aggregators.Aggregator``: the tree path is the parity
oracle of the fused norm kernels, as in the reference. Means are taken as
the reference's compiled code takes them (``aggregators.mean0``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.aggregators import (Aggregator, _tree_pair_sqdists,
                                          coord_median, coord_trimmed_mean,
                                          mean0)
from repro_torch.core.compressors import block_norms


def robust_agg_ref(x, *, bucket_size: int = 1, rule: str = "median",
                   trim: int = 1):
    """x: (n, d) already permuted worker vectors -> (d,) aggregate.

    bucket_size s: contiguous groups of s rows are averaged first (Alg. 2's
    bucketing; the random permutation is applied by the caller), a partial
    last bucket padded with the stacked mean.
    """
    n, d = x.shape
    xf = x.float()
    if bucket_size > 1:
        nb = -(-n // bucket_size)
        pad = nb * bucket_size - n
        if pad:
            xf = torch.cat([xf, mean0(xf)[None].expand(pad, d)], dim=0)
        xf = mean0(xf.reshape(nb, bucket_size, d), 1)
    if rule == "mean":
        return mean0(xf)
    if rule == "median":
        return coord_median(xf)
    if rule == "trimmed":
        return coord_trimmed_mean(xf, trim)
    raise ValueError(rule)


def pair_sqdists_ref(x):
    """(n, n) pairwise squared distances of (n, d) rows, float32, clamped
    at 0 (``aggregators._tree_pair_sqdists`` on one flat leaf)."""
    return _tree_pair_sqdists({"x": x})


def rfa_ref(x, *, iters: int = 8, eps: float = 1e-8):
    """Smoothed-Weiszfeld geometric median of (n, d) pre-bucketed rows."""
    return Aggregator("rfa", iters=iters, eps=eps)(None, x)


def krum_ref(x, *, n_byz: int = 1):
    """Krum (Eq. 15) over (n, d) pre-bucketed rows."""
    return Aggregator("krum", n_byz=n_byz)(None, x)


def block_quantize_ref(x, u, *, levels: int, block: int):
    """Block-wise l2 dithering: per contiguous block of ``block`` coords,
    q(x)_i = ||x_blk|| * sign(x_i) * floor(|x_i|/||x_blk|| * s + u_i) / s.

    x, u: (d,), zero-padded to a block multiple. The norms are the
    kernel's (``compressors.block_norms``); the division by s is a true
    division, as the reference's oracle takes it op by op (its compiled
    kernel multiplies by the rounded 1/s instead, and so does
    ``quantize.block_quantize_plain``: the two differ where s is not a
    power of two).
    """
    d = x.shape[0]
    pad = (-d) % block
    xb = F.pad(x.float(), (0, pad)).reshape(-1, block)
    ub = F.pad(u.float(), (0, pad)).reshape(-1, block)
    norm = block_norms(xb)
    scaled = torch.where(norm > 0, xb.abs() / torch.clamp(norm, min=1e-30),
                         torch.zeros((), device=x.device))
    level = torch.floor(scaled * levels + ub)
    out = norm * torch.sign(xb) * level / levels
    return out.reshape(-1)[:d].to(x.dtype)
