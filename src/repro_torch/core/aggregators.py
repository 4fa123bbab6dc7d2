"""(δ, c)-robust aggregation rules with Alg. 2 bucketing (port of
``repro/core/aggregators.py``): mean, coordinate-wise median (cm),
trimmed mean (tm), RFA (smoothed Weiszfeld) and Krum. These plain
versions are the gspmd backend and the reference the kernel backend is
held to. RFA and Krum take global distances, summed over the leaves of a
tree. ``Aggregator.tree_masked`` is the masked twin the fault guard and
partial participation use; ``Aggregator.tree_traced`` (and
``tree_masked(..., return_info=True)``) is the telemetry twin, the same
aggregate with the rules' own intermediates.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import random as R
from repro_torch.core import tree_utils as tu
from repro_torch.core.attacks import fma_f32
from repro_torch.xla_math import XLA_REDUCE_WINDOW, xla_sum_lanes


def xla_sum_rows(rows):
    """Σ of a list of float32 tensors as the reference's compiled code sums
    the rows of an array on the CPU: in order up to ``XLA_REDUCE_WINDOW``
    rows; above, zero-padded on both sides (pad // 2 rows first) to whole
    windows, each window summed in order, then the window sums the same
    way. (``Tensor.sum`` associates differently.)"""
    m = len(rows)
    if m <= XLA_REDUCE_WINDOW:
        acc = rows[0]
        for r in rows[1:]:
            acc = acc + r
        return acc
    k = -(-m // XLA_REDUCE_WINDOW)
    lo = (k * XLA_REDUCE_WINDOW - m) // 2
    cuts = ([0] + [XLA_REDUCE_WINDOW * j - lo for j in range(1, k)] + [m])
    return xla_sum_rows([xla_sum_rows(rows[a:b])
                         for a, b in zip(cuts, cuts[1:])])


def mean0(x, dim: int = 0):
    """Float32 mean as the reference's compiled code takes it: the sum of
    ``xla_sum_rows``, times the rounded reciprocal of the count."""
    rows = x.unbind(dim)
    return xla_sum_rows(rows) * (1.0 / len(rows))


def weighted_rows(w, x):
    """Σ_i w_i·x_i over axis 0 as the reference's compiled float32 code
    takes it (an einsum, or a kernel's row sum): one fused multiply-add per
    row, in row order (``attacks.fma_f32``)."""
    acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        acc = fma_f32(w[i], x[i], acc)
    return acc


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


# ---------------------------------------------------------------------------
# masked primitives (the fault guard's and partial participation's oracle;
# faults.guard supplies the validity masks and the renormalized bucket
# operator)
# ---------------------------------------------------------------------------

def _row_mask(valid, a):
    return valid.reshape((-1,) + (1,) * (a.dim() - 1))


def _zero(a):
    return torch.zeros((), dtype=a.dtype, device=a.device)


def _sanitize_rows(xs: dict, valid) -> dict:
    """Zero the invalid rows with a select, never a multiply (0·NaN =
    NaN)."""
    return tu.tree_map(lambda a: torch.where(_row_mask(valid, a), a, _zero(a)),
                       xs)


def valid_count(valid):
    """c, the number of valid rows, as an int64 device tensor."""
    return valid.to(torch.int64).sum()


def masked_mean(x, valid):
    """Mean over the valid rows: their sum in XLA's row order divided (a
    true division, by a count known only at run time) by max(c, 1)."""
    cnt = torch.clamp(valid.float().sum(), min=1.0)
    xc = torch.where(_row_mask(valid, x), x, _zero(x))
    return xla_sum_rows(list(xc.unbind(0))) / cnt.to(x.dtype)


def _sorted_with_inf_fill(x, valid):
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    return torch.sort(torch.where(_row_mask(valid, x), x, inf), dim=0).values


def masked_coord_median(x, valid):
    """Coordinate-wise median over the valid rows: invalid rows fill with
    +inf so the sort pushes them past every real entry, then the ranks
    (c-1)//2 and c//2 of the valid count c are gathered on the device.
    For odd c the two coincide and 0.5·(v + v) == v bitwise."""
    c = valid_count(valid)
    xs = _sorted_with_inf_fill(x, valid)
    lo = xs.index_select(0, torch.clamp(torch.div(c - 1, 2,
                                                  rounding_mode="floor"),
                                        min=0).reshape(1))[0]
    hi = xs.index_select(0, torch.div(c, 2, rounding_mode="floor")
                         .clamp(max=x.shape[0] - 1).reshape(1))[0]
    return 0.5 * (lo + hi)


def masked_coord_trimmed_mean(x, valid, trim: int):
    """Trimmed mean over the valid rows: sort with +inf fill, keep ranks
    [t, c - t) of the valid count c, t = min(trim, (c-1)//2); the kept
    rows, the others as zeros, summed in XLA's row order over all m rows,
    divided by max(c - 2t, 1)."""
    m = x.shape[0]
    c = valid_count(valid)
    t = torch.clamp(torch.div(c - 1, 2, rounding_mode="floor"), max=trim)
    xs = _sorted_with_inf_fill(x, valid)
    rank = torch.arange(m, device=x.device).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    keep = (rank >= t) & (rank < c - t)
    kept = torch.where(keep, xs, _zero(x))
    return (xla_sum_rows(list(kept.unbind(0)))
            / torch.clamp(c - 2 * t, min=1).to(x.dtype))


# float32 lanes of the vectors XLA on the CPU emits (256 bits)
XLA_GEMV_LANES = 8


def xla_gemv(w_mat, v):
    """(m, n) W @ (n,) v as XLA on the CPU emits a matrix-vector product
    (its tiled row-major GEMV): per row, the columns of whole 8-column
    blocks accumulate lane by lane with fused multiply-adds, the last
    n mod 8 columns into a scalar likewise, then the 8 lanes are summed,
    pairwise ((l0+l1)+(l2+l3))+((l4+l5)+(l6+l7)) in whole tiles of 8 rows
    and by halves ((l0+l4)+(l2+l6))+((l1+l5)+(l3+l7)) in the last partial
    tile, and the scalar is added."""
    m, n = w_mat.shape
    lanes = XLA_GEMV_LANES
    body = n - n % lanes
    acc = torch.zeros(m, lanes, dtype=torch.float32, device=v.device)
    for c in range(0, body, lanes):
        acc = fma_f32(w_mat[:, c:c + lanes], v[None, c:c + lanes], acc)
    tail = torch.zeros(m, dtype=torch.float32, device=v.device)
    for c in range(body, n):
        tail = fma_f32(w_mat[:, c], v[c], tail)
    a = acc.unbind(1)
    pairwise = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]))
    halves = ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]))
    full_tiles = torch.arange(m, device=v.device) < m - m % lanes
    return torch.where(full_tiles, pairwise, halves) + tail


def bucket_rows(w_mat, a):
    """W @ a over the leading axis as the reference's compiled einsum
    takes it: a 1-D leaf into more than one bucket is a matrix-vector
    product (``xla_gemv``); otherwise one fused multiply-add per row in
    row order for each bucket."""
    if a.dim() == 1 and w_mat.shape[0] > 1:
        return xla_gemv(w_mat.float(), a.float())
    flat = a.reshape(a.shape[0], -1).float()
    out = torch.stack([weighted_rows(w, flat) for w in w_mat.float()])
    return out.reshape((w_mat.shape[0],) + tuple(a.shape[1:]))


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


def _tree_pair_sqdists(xs: dict):
    """(n, n) global pairwise squared distances from a stacked tree, any
    n: the largest intermediate is the (n, n) Gram, never anything of size
    n²·d, so the reference's 64-row slabs above ``MAX_FUSED_WORKERS``
    (bounding XLA's working set) are not needed here."""
    leaves = tu.leaves(xs)
    n = leaves[0].shape[0]
    flats = [a.reshape(n, -1).float() for a in leaves]
    sq = sum(torch.sum(f * f, dim=-1) for f in flats)
    gram = sum(f @ f.T for f in flats)
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    return torch.clamp(d2, min=0.0)


def _tree_sqdist_to(xs: dict, z: dict):
    """(n,) global squared distances from each stacked row to tree z."""
    def leaf(a, b):
        diff = (a.float() - b.float()[None]).reshape(a.shape[0], -1)
        return torch.sum(diff * diff, dim=-1)

    return sum(leaf(a, b) for a, b in zip(tu.leaves(xs), tu.leaves(z)))


def _tree_weighted_sum(w, xs: dict) -> dict:
    return tu.tree_map(
        lambda a: weighted_rows(w.float(), a.float()).to(a.dtype), xs)


# registry rule name -> robust_agg kernel rule name
COORD_KERNEL_RULE = {"mean": "mean", "cm": "median", "tm": "trimmed"}


@dataclasses.dataclass(frozen=True)
class Aggregator:
    rule: str                    # mean | cm | tm | rfa | krum
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

    @property
    def norm_based(self) -> bool:
        """RFA / Krum: rules driven by global inter-worker distances,
        served by the kernels of ``kernels/norm_agg`` under
        agg_mode=pallas; this tree path is their parity oracle."""
        return self.rule in ("rfa", "krum")

    def _rule(self, x):
        if self.rule == "mean":
            return mean0(x)
        if self.rule == "cm":
            return coord_median(x)
        if self.rule == "tm":
            return coord_trimmed_mean(x, self.trim)
        raise ValueError(self.rule)

    def _masked_rule(self, x, valid):
        """The coordinate rule over the valid rows of x."""
        if self.rule == "mean":
            return masked_mean(x, valid)
        if self.rule == "cm":
            return masked_coord_median(x, valid)
        if self.rule == "tm":
            return masked_coord_trimmed_mean(x, valid, self.trim)
        raise ValueError(self.rule)

    def __call__(self, key, x):
        """Flat stacked workers x (n, d) -> (d,)."""
        if self.bucket_size > 1 and self.rule != "mean":
            x = bucketize(key, x, self.bucket_size)
        if self.norm_based:
            return self._norm_tree({"x": x})[0]["x"]
        return self._rule(x)

    def tree(self, key, xs: dict) -> dict:
        """xs: tree with leading worker axis n on every leaf; one shared
        bucketing permutation across leaves."""
        return self._tree(key, xs, False)

    def tree_traced(self, key, xs: dict):
        """``(tree(key, xs), info)``: the same aggregate by the same ops,
        and the rule's own intermediates for ``obs.trace.RoundTrace``:
        ``perm`` (the shared bucketing permutation, None without
        bucketing), and for RFA ``bucket_weights`` (the last Weiszfeld
        weights) and ``rfa_sq`` (the rows' squared distances to the
        output, one more distance pass), for Krum ``bucket_weights`` (the
        selection one-hot), ``krum_scores`` and ``krum_selected``.
        Coordinate rules return ``perm`` alone."""
        return self._tree(key, xs, True)

    def _tree(self, key, xs: dict, return_info: bool):
        n = tu.leaves(xs)[0].shape[0]
        info = {"perm": None}
        if self.bucket_size > 1 and self.rule != "mean":
            perm = R.permutation(key, n)
            info["perm"] = perm
            xs = tu.tree_map(
                lambda a: _bucketize_perm(a, perm, self.bucket_size), xs)
        if self.norm_based:
            z, extra = self._norm_tree(xs, return_info)
            info.update(extra)
        else:
            z = tu.tree_map(self._rule, xs)
        return (z, info) if return_info else z

    def tree_masked(self, key, xs: dict, valid, return_info: bool = False):
        """Guarded twin of ``tree``: rows with ``valid[i] == False`` get
        exactly zero weight. Invalid rows are select-zeroed before any
        arithmetic, each bucket renormalizes over its valid members
        (``faults.guard.masked_bucket_matrix``), and a bucket with no
        valid member is itself dropped. ``return_info`` returns ``(agg,
        info)`` as ``tree_traced`` does."""
        from repro_torch.faults.guard import masked_bucket_matrix
        n = tu.leaves(xs)[0].shape[0]
        xs = _sanitize_rows(xs, valid)
        bvalid = valid
        info = {"perm": None}
        if self.bucket_size > 1 and self.rule != "mean":
            perm = R.permutation(key, n)
            info["perm"] = perm
            w_mat, bvalid = masked_bucket_matrix(perm, n, self.bucket_size,
                                                 valid)
            xs = tu.tree_map(lambda a: bucket_rows(w_mat, a).to(a.dtype), xs)
        if self.coordinatewise:
            agg = tu.tree_map(lambda a: self._masked_rule(a, bvalid), xs)
        elif self.rule == "rfa":
            agg, extra = self._rfa_masked(xs, bvalid, return_info)
            info.update(extra)
        else:
            agg, extra = self._krum_masked(xs, bvalid)
            info.update(extra)
        return (agg, info) if return_info else agg

    def _rfa_masked(self, xs: dict, valid, return_info: bool = False):
        """Weiszfeld over the valid (already zeroed) rows: invalid rows
        get zero weight at every iteration; the start is the valid
        mean. -> (z, info)."""
        z = tu.tree_map(lambda a: masked_mean(a, valid), xs)
        v = valid.float()
        w = v / torch.clamp(v.sum(), min=1.0)
        for _ in range(self.iters):
            sq = _tree_sqdist_to(xs, z)
            w = torch.where(valid, 1.0 / torch.sqrt(sq + self.eps), 0.0)
            w = w / torch.clamp(torch.sum(w), min=1e-30)
            z = _tree_weighted_sum(w, xs)
        if not return_info:
            return z, {}
        return z, {"bucket_weights": w, "rfa_sq": _tree_sqdist_to(xs, z)}

    def _krum_masked(self, xs: dict, valid):
        """Krum over the valid rows: invalid rows and columns are +inf in
        the distance matrix, the neighbour count tracks the valid count c
        (k = max(c - n_byz - 2, 1)), and an invalid row never wins.
        -> (z, info)."""
        n = tu.leaves(xs)[0].shape[0]
        d2 = _tree_pair_sqdists(xs)
        inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
        d2 = torch.where(valid[:, None] & valid[None, :], d2, inf)
        d2 = d2 + torch.diag(inf.expand(n))
        k = torch.clamp(valid_count(valid) - self.n_byz - 2, min=1)
        near = torch.arange(n, device=d2.device)[None, :] < k
        srt = torch.sort(d2, dim=1).values
        scores = torch.where(near, srt, 0.0).sum(1)
        scores = torch.where(valid, scores, inf)
        best = torch.argmin(scores)
        onehot = F.one_hot(best, n).float()
        return _tree_weighted_sum(onehot, xs), {
            "bucket_weights": onehot, "krum_scores": scores,
            "krum_selected": best}

    def _norm_tree(self, xs: dict, return_info: bool = False):
        if self.rule == "rfa":
            return self._rfa_tree(xs, return_info)
        return self._krum_tree(xs)

    def _rfa_tree(self, xs: dict, return_info: bool = False):
        """Geometric median via smoothed Weiszfeld (Pillutla et al. 2022).
        -> (z, info)."""
        z = tu.tree_map(mean0, xs)
        n = tu.leaves(xs)[0].shape[0]
        w = torch.full((n,), 1.0 / n, dtype=torch.float32,
                       device=tu.leaves(xs)[0].device)
        for _ in range(self.iters):
            sq = _tree_sqdist_to(xs, z)
            w = 1.0 / torch.sqrt(sq + self.eps)
            w = w / torch.sum(w)
            z = _tree_weighted_sum(w, xs)
        if not return_info:
            return z, {}
        return z, {"bucket_weights": w, "rfa_sq": _tree_sqdist_to(xs, z)}

    def _krum_tree(self, xs: dict):
        """Krum (Eq. 15): the row minimizing the sum of squared distances
        to its n - n_byz - 2 nearest neighbours. -> (z, info)."""
        n = tu.leaves(xs)[0].shape[0]
        d2 = _tree_pair_sqdists(xs)
        d2 = d2 + torch.diag(torch.full((n,), float("inf"), dtype=d2.dtype,
                                        device=d2.device))
        k = max(n - self.n_byz - 2, 1)
        scores = torch.sum(torch.sort(d2, dim=1).values[:, :k], dim=1)
        best = torch.argmin(scores)
        onehot = F.one_hot(best, n).float()
        return _tree_weighted_sum(onehot, xs), {
            "bucket_weights": onehot, "krum_scores": scores,
            "krum_selected": best}


def get_aggregator(name: str, *, bucket_size: int = 0, **kw) -> Aggregator:
    if name not in RULES:
        raise ValueError(f"unknown aggregation rule {name!r}; known: {RULES}")
    return Aggregator(rule=name, bucket_size=bucket_size, **kw)
