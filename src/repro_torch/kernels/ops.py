"""Public entry points of the kernels (port of ``repro/kernels/ops.py``).

Each takes (n, d) stacked workers (float32, or bfloat16, which the kernels
load as such), or a ``quantize.WireSrc`` payload of any wire format, and
runs on the device its tensors lie on: CUDA tensors through the
hand-written kernels, CPU tensors through their plain versions. The Alg. 2
bucketing permutation is carried as the (nb, n) ``norm_agg.bucket_matrix``
operator, so ``x[perm]`` is never materialized; without a key, rows are
bucketed in order. Above ``MAX_FUSED_WORKERS`` rows the stack is bucketed
first, in plain PyTorch, and the rule runs on the bucketed rows (the
coordinate rules in plain PyTorch, RFA and Krum on the fused kernels or,
above the cap still, on the blocked ones), as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.core.aggregators import (MAX_FUSED_WORKERS, _bucketize_perm,
                                          coord_median, coord_trimmed_mean,
                                          mean0)
from repro_torch.kernels import norm_agg, quantize, ref
from repro_torch.kernels.robust_agg import robust_agg as _robust_agg


def _perm(key, n: int, device):
    """Alg. 2's permutation; rows in order when ``key`` is None."""
    if key is None:
        return torch.arange(n, device=device)
    return R.permutation(key, n).to(device)


def _perm_bucket_matrix(key, n: int, bucket_size: int, device):
    """Alg. 2 random permutation as the (nb, n) bucket operator."""
    return norm_agg.bucket_matrix(_perm(key, n, device), n, bucket_size)


def _bucket_first(x, key, bucket_size: int):
    """Giant-n prologue: the Alg. 2 bucket reduction materialized, so the
    rule only ever sees the (nb, d) bucketed stack."""
    y = x.float()
    if bucket_size > 1:
        y = _bucketize_perm(y, _perm(key, y.shape[0], y.device), bucket_size)
    return y.contiguous()


def _stack(x):
    """The (n, d) stack as the fused kernels load it: bfloat16 kept,
    anything else as float32."""
    return (x if x.dtype == torch.bfloat16 else x.float()).contiguous()


def robust_agg(x, key=None, *, bucket_size: int = 1, rule: str = "median",
               trim: int = 1):
    """Full (δ,c)-ARAgg of (n, d) stacked workers: permutation, bucket means
    and the coordinate rule (mean / median / trimmed) in one kernel."""
    if x.shape[0] > MAX_FUSED_WORKERS:
        y = _bucket_first(x, key, bucket_size)
        if rule == "mean":
            return mean0(y)
        if rule == "median":
            return coord_median(y)
        if rule == "trimmed":
            return coord_trimmed_mean(y, trim)
        raise ValueError(rule)
    w = None
    if bucket_size > 1:
        w = _perm_bucket_matrix(key, x.shape[0], bucket_size, x.device)
    return _robust_agg(_stack(x), w, rule=rule, trim=trim)


def rfa_agg(x, key=None, *, bucket_size: int = 1, iters: int = 8,
            eps: float = 1e-8):
    """Geometric median (smoothed Weiszfeld) of (n, d) stacked workers on
    the norm kernels; bucketed only with a key, as in the reference."""
    if x.shape[0] > MAX_FUSED_WORKERS:
        y = _bucket_first(x, key, bucket_size)
        if y.shape[0] <= MAX_FUSED_WORKERS:
            return norm_agg.rfa_segments([y], iters=iters, eps=eps)[0]
        return norm_agg.rfa_segments_blocked([y], iters=iters, eps=eps)[0]
    w = None
    if key is not None and bucket_size > 1:
        w = _perm_bucket_matrix(key, x.shape[0], bucket_size, x.device)
    return norm_agg.rfa_segments([_stack(x)], w_mat=w,
                                 iters=iters, eps=eps)[0]


def krum_agg(x, key=None, *, bucket_size: int = 1, n_byz: int = 1):
    """Krum (Eq. 15) of (n, d) stacked workers on the norm kernels (a Gram
    and the winner's extraction); bucketed only with a key."""
    if x.shape[0] > MAX_FUSED_WORKERS:
        y = _bucket_first(x, key, bucket_size)
        if y.shape[0] <= MAX_FUSED_WORKERS:
            return norm_agg.krum_segments([y], n_byz=n_byz)[0]
        return norm_agg.krum_segments_blocked([y], n_byz=n_byz)[0]
    w = None
    if key is not None and bucket_size > 1:
        w = _perm_bucket_matrix(key, x.shape[0], bucket_size, x.device)
    return norm_agg.krum_segments([_stack(x)], w_mat=w,
                                  n_byz=n_byz)[0]


def wire_agg(src, key=None, *, bucket_size: int = 1, rule: str = "median",
             trim: int = 1, n_byz: int = 1, iters: int = 8,
             eps: float = 1e-8):
    """ARAgg over a worker-stacked wire payload of any format
    (``quantize.WireSrc``: sparse, int8, sign or bf16): the kernels decode,
    round through the candidate dtype, add the base, bucket and apply the
    rule tile by tile, so the dense (n, d) candidates never exist in device
    memory. Any rule; bucketed only with a key."""
    w = None
    if key is not None and bucket_size > 1:
        w = _perm_bucket_matrix(key, src.n, bucket_size, src.device)
    if rule in ("mean", "median", "trimmed"):
        return _robust_agg(src, w, rule=rule, trim=trim)
    if rule == "rfa":
        return norm_agg.rfa_segments([src], w_mat=w, iters=iters,
                                     eps=eps)[0]
    if rule == "krum":
        return norm_agg.krum_segments([src], w_mat=w, n_byz=n_byz)[0]
    raise ValueError(rule)


def block_quantize(x, key, *, levels: int = 4):
    """Block-ℓ2 stochastic rounding of x (d,) with the dither drawn as
    ``uniform(key, x.shape)`` (``quantize.block_quantize``)."""
    u = R.uniform(key, x.shape).to(x.device)
    return quantize.block_quantize(x, u, levels=levels)


def robust_agg_oracle(x, *, bucket_size: int = 1, rule: str = "median",
                      trim: int = 1):
    return ref.robust_agg_ref(x, bucket_size=bucket_size, rule=rule,
                              trim=trim)


def block_quantize_oracle(x, u, *, levels: int = 4, block: int = 256):
    return ref.block_quantize_ref(x, u, levels=levels, block=block)


def rfa_oracle(x, *, iters: int = 8, eps: float = 1e-8):
    return ref.rfa_ref(x, iters=iters, eps=eps)


def krum_oracle(x, *, n_byz: int = 1):
    return ref.krum_ref(x, n_byz=n_byz)
