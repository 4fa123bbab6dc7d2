"""(δ, c)-robust aggregation rules with Alg. 2 bucketing (port of
``repro/core/aggregators.py``): mean, coordinate-wise median (cm) and
trimmed mean (tm). These plain versions are the gspmd backend and the
reference the kernel backend is held to. RFA and Krum are named so specs
validate, and raise ``NotImplementedError`` when used.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as R
from repro_torch.core import tree_utils as tu


def mean0(x, dim: int = 0):
    """Float32 mean as the reference's compiled code takes it: a sequential
    sum, times the rounded reciprocal of the count. (``Tensor.sum``
    associates the tail of a row differently.)"""
    rows = x.unbind(dim)
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc * (1.0 / len(rows))


def coord_median(x):
    """Exact coordinate-wise median over axis 0."""
    n = x.shape[0]
    xs = torch.sort(x, dim=0).values
    if n % 2:
        return xs[n // 2]
    return 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def coord_trimmed_mean(x, trim: int):
    n = x.shape[0]
    t = min(trim, (n - 1) // 2)
    xs = torch.sort(x, dim=0).values
    return mean0(xs[t:n - t])


def bucketize(key, x, s: int):
    """Alg. 2: random permutation, then average buckets of size s."""
    return _bucketize_perm(x, R.permutation(key, x.shape[0]), s)


def _bucketize_perm(x, perm, s: int):
    """Bucket means of x[perm]; a partial last bucket is padded with the
    stacked mean, so no trailing worker is dropped."""
    n = x.shape[0]
    xp = x[perm]
    n_buckets = (n + s - 1) // s
    pad = n_buckets * s - n
    if pad:
        fill = mean0(xp)[None].expand((pad,) + xp.shape[1:])
        xp = torch.cat([xp, fill], dim=0)
    return mean0(xp.reshape((n_buckets, s) + x.shape[1:]), 1)


# above this many workers the reference takes its blocked paths; the fused
# robust-aggregation kernel keeps the whole worker axis of a tile on chip
MAX_FUSED_WORKERS = 64

RULES = ("mean", "cm", "tm", "rfa", "krum")

# registry rule name -> robust_agg kernel rule name
COORD_KERNEL_RULE = {"mean": "mean", "cm": "median", "tm": "trimmed"}


@dataclasses.dataclass(frozen=True)
class Aggregator:
    rule: str                    # mean | cm | tm (rfa | krum: not ported)
    bucket_size: int = 0         # s; 0/1 = no bucketing
    trim: int = 1                # for tm
    n_byz: int = 1               # for krum
    iters: int = 8               # for rfa
    eps: float = 1e-8

    @property
    def name(self) -> str:
        nm = self.rule
        if self.rule == "tm":
            nm += str(self.trim)
        if self.bucket_size > 1:
            nm += f"_b{self.bucket_size}"
        return nm

    @property
    def robust(self) -> bool:
        return self.rule != "mean"

    @property
    def coordinatewise(self) -> bool:
        return self.rule in ("mean", "cm", "tm")

    def _rule(self, x):
        if self.rule == "mean":
            return mean0(x)
        if self.rule == "cm":
            return coord_median(x)
        if self.rule == "tm":
            return coord_trimmed_mean(x, self.trim)
        raise NotImplementedError(
            f"aggregator {self.rule!r} is not ported yet (ROADMAP queue 1, "
            "item 3; kernels in queue 2)")

    def __call__(self, key, x):
        """Flat stacked workers x (n, d) -> (d,)."""
        if self.bucket_size > 1 and self.rule != "mean":
            x = bucketize(key, x, self.bucket_size)
        return self._rule(x)

    def tree(self, key, xs: dict) -> dict:
        """xs: tree with leading worker axis n on every leaf; one shared
        bucketing permutation across leaves."""
        n = tu.leaves(xs)[0].shape[0]
        if self.bucket_size > 1 and self.rule != "mean":
            perm = R.permutation(key, n)
            xs = tu.tree_map(
                lambda a: _bucketize_perm(a, perm, self.bucket_size), xs)
        return tu.tree_map(self._rule, xs)


def get_aggregator(name: str, *, bucket_size: int = 0, **kw) -> Aggregator:
    if name not in RULES:
        raise ValueError(f"unknown aggregation rule {name!r}; known: {RULES}")
    if name not in COORD_KERNEL_RULE:
        raise NotImplementedError(
            f"aggregator {name!r} is not ported yet (ROADMAP queue 1, item 3;"
            " kernels in queue 2)")
    return Aggregator(rule=name, bucket_size=bucket_size, **kw)
