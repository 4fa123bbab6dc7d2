"""Bucketing as a linear operator and the plain aggregation prologue
(port of the parts of ``repro/kernels/norm_agg.py`` the coordinate rules
use). The Krum / RFA kernels of the reference module (``pair_gram``,
``rfa_iter``, ``weighted_sum`` and their blocked twins) are not ported
yet: ROADMAP queue 2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import quantize


def bucket_matrix(perm, n: int, s: int):
    """(nb, n) float32 W with W @ x == ``aggregators._bucketize_perm(x,
    perm, s)`` (Alg. 2): W[b, j] = (#{i in bucket b : perm[i] == j} +
    pad_b / n) / s, the partial last bucket's pad rows being the stacked
    mean."""
    nb = -(-n // s)
    pad = nb * s - n
    onehot = F.one_hot(perm.long(), n).float()                       # (n, n)
    member = F.one_hot(torch.arange(n, device=perm.device) // s,
                       nb).float()                                   # (n, nb)
    w = member.T @ onehot                                            # (nb, n)
    if pad:
        w[nb - 1, :] += pad / n
    return w / s


def src_dims(x):
    """(n, d) of a kernel input: dense (n, d) tensor or quantize.WireSrc."""
    if isinstance(x, quantize.WireSrc):
        return x.n, x.d
    return tuple(x.shape)


def prologue(x, w_mat=None, mask=None, good_mean=None, good_std=None,
             attack=None):
    """Plain form of the kernel prologue on a (n, d) float32 stack: the
    fused attack replaces the masked rows (values round-trip through the
    float32 candidate dtype, a no-op here), then xb = W @ x."""
    if attack is not None and mask is not None:
        d = x.shape[1]
        mu = None if good_mean is None else good_mean.reshape(1, d).float()
        sd = None if good_std is None else good_std.reshape(1, d).float()
        v = attack(x, mu, sd)
        x = torch.where(mask.reshape(-1, 1) > 0, v, x)
    if w_mat is not None:
        x = w_mat @ x
    return x
