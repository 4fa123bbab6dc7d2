"""Helpers over parameter trees: ``dict[str, Tensor]``, walked in sorted
key order (the order ``jax.tree.flatten`` walks a dict)."""
from __future__ import annotations

import torch

from repro_torch import random as R


def leaves(tree: dict) -> list:
    return [tree[k] for k in sorted(tree)]


def unflatten(like: dict, values) -> dict:
    return dict(zip(sorted(like), values))


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    return {k: fn(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    return tree_map(lambda x: (s * x.float()).to(x.dtype), a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_dot(a, b):
    return sum(torch.dot(x.float().reshape(-1), y.float().reshape(-1))
               for x, y in zip(leaves(a), leaves(b)))


def tree_norm_sq(a):
    return tree_dot(a, a)


def tree_size(a) -> int:
    return sum(x.numel() for x in leaves(a))


def tree_broadcast_leading(a, n: int):
    """Each leaf repeated along a new leading axis of n rows (stored, not
    a stride-0 view: the kernels read per-worker state as dense rows)."""
    return tree_map(lambda x: x.expand((n,) + tuple(x.shape)).contiguous(), a)


# masked_mean_std takes leaves wider than this many coordinates a column
# block at a time: its float32 temporaries then stay small beside a
# model-sized stack (every coordinate's arithmetic is the same)
STATS_BLOCK = 1 << 24


def masked_mean_std(xs: dict, good_mask: torch.Tensor,
                    sanitize: bool = False):
    """Per-coordinate mean/std over the good workers of a stacked tree
    (leaves (n, ...), good_mask (n,) bool) -> (mean_tree, std_tree).

    ``sanitize`` (fault guard): masked-out rows are replaced before the
    weighted sums, since a zero weight does not neutralize a non-finite
    row (0·NaN = NaN)."""
    g = good_mask.float()
    cnt = torch.clamp(g.sum(), min=1.0)

    def blocked(fn, a, *rest):
        """fn over column blocks of the leaf's flat (n, d) rows."""
        d = a[0].numel()
        if d <= STATS_BLOCK:
            return fn(a, *rest)
        flat = a.reshape(a.shape[0], d)
        rest = [r.reshape(d) for r in rest]
        out = torch.empty(d, dtype=torch.float32, device=a.device)
        for c in range(0, d, STATS_BLOCK):
            sl = slice(c, c + STATS_BLOCK)
            out[sl] = fn(flat[:, sl], *(r[sl] for r in rest))
        return out.reshape(a.shape[1:])

    def mean_leaf(a):
        w = g.reshape((-1,) + (1,) * (a.dim() - 1))
        af = a.float()
        if sanitize:
            af = torch.where(w > 0.0, af, 0.0)
        return (af * w).sum(0) / cnt

    means = tree_map(lambda a: blocked(mean_leaf, a), xs)

    def std_leaf(a, m):
        w = g.reshape((-1,) + (1,) * (a.dim() - 1))
        af = a.float()
        if sanitize:
            af = torch.where(w > 0.0, af, m[None])
        var = ((af - m[None]).square() * w).sum(0) / cnt
        # float64, rounded once: the correctly rounded float32 root (XLA's
        # and CUDA's), which torch's vectorized CPU sqrt misses by an ulp
        return torch.sqrt(torch.clamp(var, min=0.0).double()).float()

    return means, tree_map(lambda a, m: blocked(std_leaf, a, m), xs, means)


def per_worker_keys(key, n: int, *, common: bool = False):
    """(n, 2) keys: fold_in(key, i) per worker, or key broadcast."""
    if common:
        return key.expand(n, 2)
    return R.fold_in(key, torch.arange(n, device=key.device))


def compress_tree(compressor, key, tree: dict) -> dict:
    """Leaf i (sorted order) compresses under fold_in(key, i)."""
    return unflatten(tree, [compressor.compress(R.fold_in(key, i), leaf)
                            for i, leaf in enumerate(leaves(tree))])


def compress_stacked(compressor, qkeys, stacked: dict, base=None,
                     consume: bool = False) -> dict:
    """``compress_tree`` of every worker's row of a stacked tree under its
    own key (the reference's ``vmap(compress_tree)``), leaf by leaf: leaf
    i of worker w compresses under fold_in(qkeys[w], i). ``base`` (a tree
    of unstacked leaves) is added to each leaf's rows, base[None] + Q, as
    soon as the leaf is made; ``consume`` pops each input leaf from
    ``stacked`` once compressed, so that a model-sized stack is not held
    three times over (input, compressed rows, candidates)."""
    out = {}
    for i, k in enumerate(sorted(stacked)):
        leaf = stacked.pop(k) if consume else stacked[k]
        q = torch.stack([compressor.compress(R.fold_in(qkeys[w], i), leaf[w])
                         for w in range(qkeys.shape[0])])
        del leaf
        out[k] = q if base is None else base[k][None] + q
    return out
