"""The norm-based aggregation kernels, their plain versions and the rule
drivers (port of ``repro/kernels/norm_agg.py``), with the bucket operator
and the attack/bucket prologue the coordinate kernel shares.

Kernel entry points, each on a dense (n, d) float32 stack or a sparse
``quantize.WireSrc``, with the optional fused attack (BF / ALIE / IPM from
the byzantine mask and the good workers' mean / std):

* ``pair_gram``    — the (m, m) Gram of the attacked, bucketed stack
                     (Krum's pairwise distances);
* ``rfa_iter``     — z = wᵀ·xb and sq_b = ‖xb_b − z‖² in one pass (one
                     smoothed-Weiszfeld iteration);
* ``weighted_sum`` — Σ_i w_i·sent_i over the n attacked rows; bucketing
                     rides in the weights.

On a CUDA tensor each launches its hand-written kernel in
``csrc/norm_agg.cu`` (or raises); on a CPU tensor it runs its ``*_plain``
version. ``rfa_segments`` and ``krum_segments`` drive them over a list of
segments with global distances, staying on the device between launches.
Not ported yet: the blocked kernels for n > 64 (ROADMAP queue 2), the
fault-guard masks and the telemetry returns (queue 1, items 7 and 8).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.aggregators import weighted_rows
from repro_torch.kernels import _build, _launch, quantize


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


def stack(x):
    """The dense (n, d) float32 candidates of a kernel input."""
    if isinstance(x, quantize.WireSrc):
        return quantize.recon(x)
    return x.float()


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


# ---------------------------------------------------------------------------
# plain versions (the op order of the reference's kernel bodies)
# ---------------------------------------------------------------------------

def pair_gram_plain(x, w_mat=None, mask=None, good_mean=None, good_std=None,
                    *, attack=None):
    """(m, m) Gram xb @ xbᵀ of the attacked, bucketed stack: its upper
    triangle, mirrored as the kernel mirrors it, so that G is symmetric
    bit for bit and Krum's tied scores (a mutual nearest pair) tie
    exactly."""
    xb = prologue(stack(x), w_mat, mask, good_mean, good_std, attack)
    g = xb @ xb.T
    return torch.triu(g) + torch.triu(g, 1).T


def rfa_iter_plain(x, w, w_mat=None, mask=None, good_mean=None,
                   good_std=None, *, attack=None):
    """(z (d,), sq (m,)): z = Σ_b w_b·xb_b, one fused multiply-add per row
    in row order; sq_b = ‖xb_b − z‖²."""
    xb = prologue(stack(x), w_mat, mask, good_mean, good_std, attack)
    z = weighted_rows(w, xb)
    diff = xb - z
    return z, (diff * diff).sum(1)


def weighted_sum_plain(x, w, mask=None, good_mean=None, good_std=None, *,
                       attack=None):
    """Σ_i w_i·sent_i over the attacked rows, as ``rfa_iter_plain``'s z."""
    return weighted_rows(w, prologue(stack(x), None, mask, good_mean,
                                     good_std, attack))


# ---------------------------------------------------------------------------
# kernel entry points
# ---------------------------------------------------------------------------

def pair_gram(x, w_mat=None, mask=None, good_mean=None, good_std=None, *,
              attack=None):
    """(n, d) stack or WireSrc -> (m, m) float32 Gram of the attacked,
    bucketed stack (m = W's rows, or n). CPU tensors take the plain
    version; CUDA tensors the kernel."""
    pair_gram.calls += 1
    if _launch.on_cpu("pair_gram", x.device):
        return pair_gram_plain(x, w_mat, mask, good_mean, good_std,
                               attack=attack)
    return _launch_pair_gram(x, w_mat, mask, good_mean, good_std, attack)


def rfa_iter(x, w, w_mat=None, mask=None, good_mean=None, good_std=None, *,
             attack=None):
    """(n, d) stack or WireSrc, weights w (m,) -> (z (d,), sq (m,))
    float32, as ``rfa_iter_plain``. CPU tensors take the plain version;
    CUDA tensors the kernel."""
    rfa_iter.calls += 1
    if _launch.on_cpu("rfa_iter", x.device):
        return rfa_iter_plain(x, w, w_mat, mask, good_mean, good_std,
                              attack=attack)
    return _launch_rfa_iter(x, w, w_mat, mask, good_mean, good_std, attack)


def weighted_sum(x, w, mask=None, good_mean=None, good_std=None, *,
                 attack=None):
    """(n, d) stack or WireSrc, weights w (n,) -> (d,) float32
    Σ_i w_i·sent_i. CPU tensors take the plain version; CUDA tensors the
    kernel."""
    weighted_sum.calls += 1
    if _launch.on_cpu("weighted_sum", x.device):
        return weighted_sum_plain(x, w, mask, good_mean, good_std,
                                  attack=attack)
    return _launch_weighted_sum(x, w, mask, good_mean, good_std, attack)


# calls: every call, plain or kernel; launches: kernel launches alone
for _fn in (pair_gram, rfa_iter, weighted_sum):
    _fn.calls = _fn.launches = 0

_KERNEL = {"pair_gram": 0, "rfa_iter": 1}    # norm_agg_blocks selector
_RESIDENT: dict = {}


def _lib():
    lib = _build.load("norm_agg")
    if lib.pair_gram_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.norm_agg_tile.argtypes = []
        lib.norm_agg_blocks.argtypes = [i] * 5
        lib.pair_gram_launch.argtypes = _launch.SRC_ARGTYPES + [
            p, i, i, p, p, p]
        lib.rfa_iter_launch.argtypes = _launch.SRC_ARGTYPES + [
            p, i, p, i, p, p, p, p]
        lib.weighted_sum_launch.argtypes = _launch.SRC_ARGTYPES + [p, p, p]
        for fn in (lib.norm_agg_tile, lib.norm_agg_blocks,
                   lib.pair_gram_launch, lib.rfa_iter_launch,
                   lib.weighted_sum_launch):
            fn.restype = ctypes.c_int
    return lib


def _blocks(lib, who, x, n, m, bucketed, d):
    """Grid of a looping kernel: as many blocks as are resident on the
    card at once, and no more than there are tiles."""
    key = (who, x.device.index, isinstance(x, quantize.WireSrc), n, m,
           bucketed)
    if key not in _RESIDENT:
        got = lib.norm_agg_blocks(_KERNEL[who], int(key[2]), n, m,
                                  int(bucketed))
        if got <= 0:
            raise RuntimeError(f"{who}: occupancy query failed: CUDA error "
                               f"{-got}")
        _RESIDENT[key] = got
    return min(_RESIDENT[key], -(-d // lib.norm_agg_tile()))


def _launch_pair_gram(x, w_mat, mask, good_mean, good_std, attack):
    n, d = src_dims(x)
    lib = _lib()
    dev = x.device
    args, keep = _launch.src_args("pair_gram", x, n, d, mask, good_mean,
                                  good_std, attack, lib.norm_agg_tile())
    m, w_ptr = _launch.bucket_args("pair_gram", w_mat, n, dev)
    blocks = _blocks(lib, "pair_gram", x, n, m, w_mat is not None, d)
    part = torch.empty(blocks, m * (m + 1) // 2, dtype=torch.float32,
                       device=dev)
    out = torch.empty(m, m, dtype=torch.float32, device=dev)
    err = lib.pair_gram_launch(*args, w_ptr, m, blocks, part.data_ptr(),
                               out.data_ptr(), _launch.stream(dev))
    _launch.raise_on("pair_gram", err)
    pair_gram.launches += 1
    return out


def _launch_rfa_iter(x, w, w_mat, mask, good_mean, good_std, attack):
    n, d = src_dims(x)
    lib = _lib()
    dev = x.device
    args, keep = _launch.src_args("rfa_iter", x, n, d, mask, good_mean,
                                  good_std, attack, lib.norm_agg_tile())
    m, w_ptr = _launch.bucket_args("rfa_iter", w_mat, n, dev)
    wr = _launch.check("rfa_iter", "w", w, dev, torch.float32, (m,))
    blocks = _blocks(lib, "rfa_iter", x, n, m, w_mat is not None, d)
    part = torch.empty(blocks, m, dtype=torch.float32, device=dev)
    z = torch.empty(d, dtype=torch.float32, device=dev)
    sq = torch.empty(m, dtype=torch.float32, device=dev)
    err = lib.rfa_iter_launch(*args, w_ptr, m, wr, blocks, part.data_ptr(),
                              z.data_ptr(), sq.data_ptr(),
                              _launch.stream(dev))
    _launch.raise_on("rfa_iter", err)
    rfa_iter.launches += 1
    return z, sq


def _launch_weighted_sum(x, w, mask, good_mean, good_std, attack):
    n, d = src_dims(x)
    lib = _lib()
    dev = x.device
    args, keep = _launch.src_args("weighted_sum", x, n, d, mask, good_mean,
                                  good_std, attack, lib.norm_agg_tile())
    wr = _launch.check("weighted_sum", "w", w, dev, torch.float32, (n,))
    out = torch.empty(d, dtype=torch.float32, device=dev)
    err = lib.weighted_sum_launch(*args, wr, out.data_ptr(),
                                  _launch.stream(dev))
    _launch.raise_on("weighted_sum", err)
    weighted_sum.launches += 1
    return out


# ---------------------------------------------------------------------------
# rule drivers over segment lists (one logical (n, Σd_j) stack, leaf-wise)
# ---------------------------------------------------------------------------
#
# A segment is one (n, d_j) view of the stacked candidate tree: a large
# leaf, the packed buffer of the small leaves, or one leaf's wire payload.
# Global distances sum tiny per-segment accumulators in segment order. The
# drivers never read a device value on the host: weights, scores and the
# Krum winner stay tensors between launches.

def rfa_segments(segs, *, w_mat=None, mask=None, means=None, stds=None,
                 attack=None, iters: int = 8, eps: float = 1e-8):
    """Smoothed Weiszfeld (Pillutla et al. 2022) with global distances
    across segments, ``Aggregator._rfa_tree``'s semantics: uniform w_0
    makes the first pass's z the (bucketed) mean, each ``rfa_iter`` pass
    gives the distances to z_t, and a final ``weighted_sum`` with w_eff =
    w_T @ W realizes z_T. Returns the per-segment (d_j,) aggregates."""
    n = src_dims(segs[0])[0]
    m = w_mat.shape[0] if w_mat is not None else n
    means = means if means is not None else [None] * len(segs)
    stds = stds if stds is not None else [None] * len(segs)
    w = torch.full((m,), 1.0 / m, dtype=torch.float32, device=segs[0].device)
    for _ in range(iters):
        sq = sum(rfa_iter(xs, w, w_mat, mask, mu, sd, attack=attack)[1]
                 for xs, mu, sd in zip(segs, means, stds))
        w = 1.0 / torch.sqrt(sq + eps)
        w = w / torch.clamp(torch.sum(w), min=1e-30)
    w_eff = w if w_mat is None else w @ w_mat
    return [weighted_sum(xs, w_eff, mask, mu, sd, attack=attack)
            for xs, mu, sd in zip(segs, means, stds)]


def krum_select(g, n_byz: int):
    """Krum scoring (Eq. 15) from an (m, m) Gram matrix: the tiny O(m²)
    step between the two kernel passes. Returns ``(onehot, scores,
    best)``: the winner's one-hot over the (bucketed) rows, the per-row
    scores and the argmin, all device tensors."""
    m = g.shape[0]
    sq = torch.diagonal(g)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * g, min=0.0)
    d2 = d2 + torch.diag(torch.full((m,), float("inf"), dtype=d2.dtype,
                                    device=d2.device))
    k = max(m - n_byz - 2, 1)
    scores = torch.sort(d2, dim=1).values[:, :k].sum(1)
    best = torch.argmin(scores)
    onehot = (torch.arange(m, device=g.device) == best).float()
    return onehot, scores, best


def krum_segments(segs, *, w_mat=None, mask=None, means=None, stds=None,
                  attack=None, n_byz: int = 1):
    """Krum (Eq. 15) in two passes, ``Aggregator._krum_tree``'s semantics:
    one ``pair_gram`` per segment (global pairwise distances), the scoring
    (``krum_select``), one ``weighted_sum`` per segment extracting the
    winner through w_eff = onehot @ W."""
    means = means if means is not None else [None] * len(segs)
    stds = stds if stds is not None else [None] * len(segs)
    g = sum(pair_gram(xs, w_mat, mask, mu, sd, attack=attack)
            for xs, mu, sd in zip(segs, means, stds))
    onehot, _, _ = krum_select(g, n_byz)
    w_eff = onehot if w_mat is None else onehot @ w_mat
    return [weighted_sum(xs, w_eff, mask, mu, sd, attack=attack)
            for xs, mu, sd in zip(segs, means, stds)]
