"""The norm-based aggregation kernels, their plain versions and the rule
drivers (port of ``repro/kernels/norm_agg.py``), with the bucket operator
and the attack/bucket prologue the coordinate kernel shares.

Kernel entry points, each on a dense (n, d) float32 or bfloat16 stack or
a ``quantize.WireSrc`` of any wire format, with the optional fused attack
(BF / ALIE / IPM from the byzantine mask and the good workers' mean /
std; under a bfloat16 candidate dtype the forged rows round through
bfloat16 before the select):

* ``pair_gram``    — the (m, m) Gram of the attacked, bucketed stack
                     (Krum's pairwise distances);
* ``rfa_iter``     — z = wᵀ·xb and sq_b = ‖xb_b − z‖² in one pass (one
                     smoothed-Weiszfeld iteration);
* ``weighted_sum`` — Σ_i w_i·sent_i over the n attacked rows; bucketing
                     rides in the weights.

On a CUDA tensor each launches its hand-written kernel in
``csrc/norm_agg.cu``, one device operation a call (or raises); on a CPU
tensor it runs its ``*_plain`` version. ``rfa_segments`` and
``krum_segments`` drive them over a list of segments with global
distances, staying on the device between launches; ``rfa_segments`` reads
sq alone, so its kernel writes no z.

The blocked kernels serve the giant-n tier (more than
``MAX_FUSED_WORKERS`` bucketed rows), on a dense (m, d) float32 stack
whose attack and bucketing are already applied:

* ``pair_gram_blocked``    — the (m, m) Gram, m unbounded;
* ``sqdist_to_blocked``    — (m,) squared distances of the rows to z;
* ``weighted_sum_blocked`` — Σ_i w_i·x_i.

Their kernels are in ``csrc/norm_agg_blocked.cu``, one launch a call each
(the Gram's product on the tensor cores, in split float32);
``rfa_segments_blocked`` and ``krum_segments_blocked`` drive them.

Under the fault guard or partial participation the fused kernels take a
(n,) ``valid`` mask, which their load applies after the attack and before
W (invalid rows become zeros), and every driver takes the (m,) bucket
validity ``bvalid``, which it applies to the weights and the scores; the
blocked kernels take no mask (the giant-n tier zeroes the rows before
bucketing).

``return_info=True`` on the four drivers also returns the rule's own
intermediates, tensors the driver holds anyway: RFA's last Weiszfeld
weights (``bucket_weights``), Krum's selection one-hot, scores and
winner (``bucket_weights``, ``krum_scores``, ``krum_selected``). The
launches and their arguments are those of ``return_info=False``: the
reference spends one more fused pass on RFA's distances to its output,
which the telemetry (``obs.trace``) takes instead from the bucketed stack
it materializes anyway.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.aggregators import (MAX_FUSED_WORKERS, weighted_rows,
                                          xla_sum_rows)
from repro_torch.kernels import _build, _launch, quantize
from repro_torch.xla_math import XLA_REDUCE_WINDOW

DEFAULT_TILE_D = 2048     # the reference's column tile
DEFAULT_TILE_N = 64       # worker tile of the blocked weighted sum


def _tile_for(d: int) -> int:
    """The reference's column tile: 128-aligned, shrunk for small d."""
    return min(DEFAULT_TILE_D, max(128, -(-d // 128) * 128))


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


def cand_dtype(x):
    """The candidates' dtype: the wire's ``cand_dtype``, or the stack's."""
    return x.cand_dtype if isinstance(x, quantize.WireSrc) else x.dtype


def prologue(x, w_mat=None, mask=None, good_mean=None, good_std=None,
             attack=None, valid=None, cand=torch.float32):
    """Plain form of the kernel prologue on a (n, d) float32 stack: the
    fused attack replaces the masked rows (the forged values round-trip
    through the candidate dtype ``cand``), then the fault guard's
    ``valid`` select zeroes the invalid rows (a select, never a multiply:
    0·NaN = NaN; an attacked row that is invalid stays zero), then
    xb = W @ x."""
    if attack is not None and mask is not None:
        d = x.shape[1]
        mu = None if good_mean is None else good_mean.reshape(1, d).float()
        sd = None if good_std is None else good_std.reshape(1, d).float()
        v = attack(x, mu, sd).to(cand).float()
        x = torch.where(mask.reshape(-1, 1) > 0, v, x)
    if valid is not None:
        x = torch.where(valid.reshape(-1, 1) > 0, x, 0.0)
    if w_mat is not None:
        x = w_mat @ x
    return x


# ---------------------------------------------------------------------------
# plain versions (the op order of the reference's kernel bodies)
# ---------------------------------------------------------------------------

def kernel_row_sum(w, x):
    """Σ_i w_i·x_i over the rows of a (m, d) block as the reference's
    compiled kernel body takes ``jnp.sum(x * w, axis=0)`` on the CPU: up to
    32 rows, one fused multiply-add per row in row order
    (``weighted_rows``); above, the rounded products summed in XLA's
    windows (``xla_sum_rows``)."""
    if x.shape[0] <= XLA_REDUCE_WINDOW:
        return weighted_rows(w, x)
    return xla_sum_rows(list((x * w.float()[:, None]).unbind(0)))


def pair_gram_plain(x, w_mat=None, mask=None, good_mean=None, good_std=None,
                    valid=None, *, attack=None):
    """(m, m) Gram xb @ xbᵀ of the attacked, bucketed stack: its upper
    triangle, mirrored as the kernel mirrors it, so that G is symmetric
    bit for bit and Krum's tied scores (a mutual nearest pair) tie
    exactly."""
    xb = prologue(stack(x), w_mat, mask, good_mean, good_std, attack, valid,
                  cand_dtype(x))
    g = xb @ xb.T
    return torch.triu(g) + torch.triu(g, 1).T


def rfa_iter_plain(x, w, w_mat=None, mask=None, good_mean=None,
                   good_std=None, valid=None, *, attack=None):
    """(z (d,), sq (m,)): z = Σ_b w_b·xb_b in the kernel body's order
    (``kernel_row_sum``); sq_b = ‖xb_b − z‖²."""
    xb = prologue(stack(x), w_mat, mask, good_mean, good_std, attack, valid,
                  cand_dtype(x))
    z = kernel_row_sum(w, xb)
    diff = xb - z
    return z, (diff * diff).sum(1)


def weighted_sum_plain(x, w, mask=None, good_mean=None, good_std=None,
                       valid=None, *, attack=None):
    """Σ_i w_i·sent_i over the attacked (and guarded) rows, as
    ``rfa_iter_plain``'s z."""
    return kernel_row_sum(w, prologue(stack(x), None, mask, good_mean,
                                      good_std, attack, valid,
                                      cand_dtype(x)))


# ---------------------------------------------------------------------------
# kernel entry points
# ---------------------------------------------------------------------------

def pair_gram(x, w_mat=None, mask=None, good_mean=None, good_std=None,
              valid=None, *, attack=None):
    """(n, d) stack or WireSrc -> (m, m) float32 Gram of the attacked,
    guarded, bucketed stack (m = W's rows, or n). CPU tensors take the
    plain version; CUDA tensors the kernel."""
    pair_gram.calls += 1
    if _launch.on_cpu("pair_gram", x.device):
        return pair_gram_plain(x, w_mat, mask, good_mean, good_std, valid,
                               attack=attack)
    return _launch_pair_gram(x, w_mat, mask, good_mean, good_std, valid,
                             attack)


def rfa_iter(x, w, w_mat=None, mask=None, good_mean=None, good_std=None,
             valid=None, *, attack=None):
    """(n, d) stack or WireSrc, weights w (m,) -> (z (d,), sq (m,))
    float32, as ``rfa_iter_plain``. CPU tensors take the plain version;
    CUDA tensors the kernel."""
    return _rfa_iter(x, w, w_mat, mask, good_mean, good_std, valid, attack,
                     True)


def _rfa_sq(x, w, w_mat=None, mask=None, good_mean=None, good_std=None,
            valid=None, *, attack=None):
    """``rfa_iter``'s sq alone, for the drivers: the kernel writes no z.
    Counted as an ``rfa_iter`` call."""
    return _rfa_iter(x, w, w_mat, mask, good_mean, good_std, valid, attack,
                     False)[1]


def _rfa_iter(x, w, w_mat, mask, good_mean, good_std, valid, attack,
              with_z):
    rfa_iter.calls += 1
    if _launch.on_cpu("rfa_iter", x.device):
        return rfa_iter_plain(x, w, w_mat, mask, good_mean, good_std, valid,
                              attack=attack)
    return _launch_rfa_iter(x, w, w_mat, mask, good_mean, good_std, valid,
                            attack, with_z)


def weighted_sum(x, w, mask=None, good_mean=None, good_std=None,
                 valid=None, *, attack=None):
    """(n, d) stack or WireSrc, weights w (n,) -> (d,) float32
    Σ_i w_i·sent_i. CPU tensors take the plain version; CUDA tensors the
    kernel."""
    weighted_sum.calls += 1
    if _launch.on_cpu("weighted_sum", x.device):
        return weighted_sum_plain(x, w, mask, good_mean, good_std, valid,
                                  attack=attack)
    return _launch_weighted_sum(x, w, mask, good_mean, good_std, valid,
                                attack)


# calls: every call, plain or kernel; launches: kernel launches alone,
# split per load (_launch.reset_counts)
for _fn in (pair_gram, rfa_iter, weighted_sum):
    _fn.calls = 0
    _launch.reset_counts(_fn)

_KERNEL = {"pair_gram": 0, "rfa_iter": 1}    # norm_agg_grid selector
_RESIDENT: dict = {}
_TICKETS: dict = {}


def _lib():
    lib = _build.load("norm_agg")
    if lib.pair_gram_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.norm_agg_grid.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        lib.finish_tickets.argtypes = []
        lib.pair_gram_launch.argtypes = _launch.SRC_ARGTYPES + [
            p, i, i, p, p, p, p]
        lib.rfa_iter_launch.argtypes = _launch.SRC_ARGTYPES + [
            p, i, p, i, p, p, p, p, p]
        lib.weighted_sum_launch.argtypes = _launch.SRC_ARGTYPES + [p, p, p]
        for fn in (lib.norm_agg_grid, lib.finish_tickets,
                   lib.pair_gram_launch, lib.rfa_iter_launch,
                   lib.weighted_sum_launch):
            fn.restype = ctypes.c_int
    return lib


def _blocks(lib, who, load, device, n, m, bucketed, d):
    """Grid of a one-launch kernel: as many blocks as are resident on the
    card at once, and no more than there are column groups (the path by m
    sets the group)."""
    key = (who, device.index, load, n, m, bucketed)
    if key not in _RESIDENT:
        group = ctypes.c_int(0)
        got = lib.norm_agg_grid(_KERNEL[who], _launch.LOADS.index(load), n,
                                m, int(bucketed), ctypes.byref(group))
        if got <= 0:
            raise RuntimeError(f"{who}: occupancy query failed: CUDA error "
                               f"{-got}")
        _RESIDENT[key] = got, group.value
    got, group = _RESIDENT[key]
    return min(got, -(-d // group))


def _tickets(lib, device, stream) -> int:
    """The one-launch finish's tickets for ``stream`` (``blocks_finish`` in
    csrc/finish.cuh, which the fused and the blocked kernels share): a
    uint32 buffer zeroed once, when it is made, and left at zero by every
    launch, so that launches on two streams never count into one
    buffer."""
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(lib.finish_tickets(),
                                    dtype=torch.int32, device=device)
    return _TICKETS[key].data_ptr()


def _finish_part(blocks, entries, device):
    """The one-launch finish's workspace: the blocks' partial sums, then
    their groups' of 16 (``blocks_finish`` in csrc/finish.cuh)."""
    return torch.empty(blocks + -(-blocks // 16), entries,
                       dtype=torch.float32, device=device)


def _launch_pair_gram(x, w_mat, mask, good_mean, good_std, valid, attack):
    n, d = src_dims(x)
    lib = _lib()
    dev = x.device
    args, load = _launch.src_args("pair_gram", x, n, d, mask, good_mean,
                                  good_std, attack, valid)
    m, w_ptr = _launch.bucket_args("pair_gram", w_mat, n, dev)
    blocks = _blocks(lib, "pair_gram", load, dev, n, m, w_mat is not None,
                     d)
    part = _finish_part(blocks, m * (m + 1) // 2, dev)
    out = torch.empty(m, m, dtype=torch.float32, device=dev)
    st = _launch.stream(dev)
    err = lib.pair_gram_launch(*args, w_ptr, m, blocks, part.data_ptr(),
                               out.data_ptr(), _tickets(lib, dev, st), st)
    _launch.raise_on("pair_gram", err)
    _launch.count(pair_gram, load, valid is not None)
    return out


def _launch_rfa_iter(x, w, w_mat, mask, good_mean, good_std, valid, attack,
                     with_z):
    n, d = src_dims(x)
    lib = _lib()
    dev = x.device
    args, load = _launch.src_args("rfa_iter", x, n, d, mask, good_mean,
                                  good_std, attack, valid)
    m, w_ptr = _launch.bucket_args("rfa_iter", w_mat, n, dev)
    wr = _launch.check("rfa_iter", "w", w, dev, torch.float32, (m,))
    blocks = _blocks(lib, "rfa_iter", load, dev, n, m, w_mat is not None,
                     d)
    part = _finish_part(blocks, m, dev)
    z = torch.empty(d, dtype=torch.float32, device=dev) if with_z else None
    sq = torch.empty(m, dtype=torch.float32, device=dev)
    st = _launch.stream(dev)
    err = lib.rfa_iter_launch(*args, w_ptr, m, wr, blocks, part.data_ptr(),
                              None if z is None else z.data_ptr(),
                              sq.data_ptr(), _tickets(lib, dev, st), st)
    _launch.raise_on("rfa_iter", err)
    _launch.count(rfa_iter, load, valid is not None)
    return z, sq


def _launch_weighted_sum(x, w, mask, good_mean, good_std, valid, attack):
    n, d = src_dims(x)
    lib = _lib()
    dev = x.device
    args, load = _launch.src_args("weighted_sum", x, n, d, mask, good_mean,
                                  good_std, attack, valid)
    wr = _launch.check("weighted_sum", "w", w, dev, torch.float32, (n,))
    out = torch.empty(d, dtype=torch.float32, device=dev)
    err = lib.weighted_sum_launch(*args, wr, out.data_ptr(),
                                  _launch.stream(dev))
    _launch.raise_on("weighted_sum", err)
    _launch.count(weighted_sum, load, valid is not None)
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

def _start_weights(m, bvalid, device):
    """Weiszfeld's first weights: uniform over the rows, or over the valid
    rows, bvalid / max(Σ bvalid, 1), counted on the device."""
    if bvalid is None:
        return torch.full((m,), 1.0 / m, dtype=torch.float32, device=device)
    bv = bvalid.float()
    return bv / torch.clamp(bv.sum(), min=1.0)


def _next_weights(sq, eps, bvalid):
    """1 / sqrt(sq + eps), pinned to 0 on invalid rows, normalized."""
    w = 1.0 / torch.sqrt(sq + eps)
    if bvalid is not None:
        w = torch.where(bvalid, w, 0.0)
    return w / torch.clamp(torch.sum(w), min=1e-30)


def rfa_segments(segs, *, w_mat=None, mask=None, means=None, stds=None,
                 attack=None, iters: int = 8, eps: float = 1e-8,
                 valid=None, bvalid=None, return_info: bool = False):
    """Smoothed Weiszfeld (Pillutla et al. 2022) with global distances
    across segments, ``Aggregator._rfa_tree``'s semantics: uniform w_0
    makes the first pass's z the (bucketed) mean, each ``rfa_iter`` pass
    gives the distances to z_t (sq alone: the kernel writes no z), and a
    final ``weighted_sum`` with w_eff = w_T @ W realizes z_T. Returns the
    per-segment (d_j,) aggregates.

    ``valid`` / ``bvalid`` (fault guard, partial participation): the
    kernels select-zero the invalid worker rows in their load, and the
    weights of invalid (bucketed) rows are pinned to zero every iteration,
    ``Aggregator._rfa_masked``'s semantics. ``return_info`` also returns
    ``{"bucket_weights": w_T}`` (module docstring)."""
    n = src_dims(segs[0])[0]
    m = w_mat.shape[0] if w_mat is not None else n
    means = means if means is not None else [None] * len(segs)
    stds = stds if stds is not None else [None] * len(segs)
    w = _start_weights(m, bvalid, segs[0].device)
    for _ in range(iters):
        sq = sum(_rfa_sq(xs, w, w_mat, mask, mu, sd, valid, attack=attack)
                 for xs, mu, sd in zip(segs, means, stds))
        w = _next_weights(sq, eps, bvalid)
    w_eff = w if w_mat is None else w @ w_mat
    outs = [weighted_sum(xs, w_eff, mask, mu, sd, valid, attack=attack)
            for xs, mu, sd in zip(segs, means, stds)]
    return (outs, {"bucket_weights": w}) if return_info else outs


def krum_select(g, n_byz: int, bvalid=None):
    """Krum scoring (Eq. 15) from an (m, m) Gram matrix: the tiny O(m²)
    step between the two kernel passes. Returns ``(onehot, scores,
    best)``: the winner's one-hot over the (bucketed) rows, the per-row
    scores and the argmin, all device tensors.

    ``bvalid``: invalid rows and columns leave the distance pool (+inf),
    the neighbour count tracks the valid count c, k = max(c - n_byz - 2,
    1), counted on the device, and an invalid row scores +inf
    (``Aggregator._krum_masked``)."""
    m = g.shape[0]
    sq = torch.diagonal(g)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * g, min=0.0)
    inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
    d2 = d2 + torch.diag(inf.expand(m))
    if bvalid is None:
        k = max(m - n_byz - 2, 1)
        scores = torch.sort(d2, dim=1).values[:, :k].sum(1)
    else:
        d2 = torch.where(bvalid[:, None] & bvalid[None, :], d2, inf)
        kv = torch.clamp(bvalid.to(torch.int64).sum() - n_byz - 2, min=1)
        near = torch.arange(m, device=g.device)[None, :] < kv
        srt = torch.sort(d2, dim=1).values
        scores = torch.where(near, srt, 0.0).sum(1)
        scores = torch.where(bvalid, scores, inf)
    best = torch.argmin(scores)
    onehot = (torch.arange(m, device=g.device) == best).float()
    return onehot, scores, best


def krum_segments(segs, *, w_mat=None, mask=None, means=None, stds=None,
                  attack=None, n_byz: int = 1, valid=None, bvalid=None,
                  return_info: bool = False):
    """Krum (Eq. 15) in two passes, ``Aggregator._krum_tree``'s semantics:
    one ``pair_gram`` per segment (global pairwise distances), the scoring
    (``krum_select``), one ``weighted_sum`` per segment extracting the
    winner through w_eff = onehot @ W. ``valid`` / ``bvalid`` as in
    ``rfa_segments``; ``return_info`` also returns the scoring's
    ``bucket_weights`` (the one-hot), ``krum_scores`` and
    ``krum_selected``."""
    means = means if means is not None else [None] * len(segs)
    stds = stds if stds is not None else [None] * len(segs)
    g = sum(pair_gram(xs, w_mat, mask, mu, sd, valid, attack=attack)
            for xs, mu, sd in zip(segs, means, stds))
    onehot, scores, best = krum_select(g, n_byz, bvalid)
    w_eff = onehot if w_mat is None else onehot @ w_mat
    outs = [weighted_sum(xs, w_eff, mask, mu, sd, valid, attack=attack)
            for xs, mu, sd in zip(segs, means, stds)]
    return (outs, _krum_info(onehot, scores, best)) if return_info else outs


def _krum_info(onehot, scores, best) -> dict:
    return {"bucket_weights": onehot, "krum_scores": scores,
            "krum_selected": best}


# ---------------------------------------------------------------------------
# the blocked kernels of the giant-n tier (dense, prologue already applied)
# ---------------------------------------------------------------------------
#
# The plain versions repeat the reference's tiling where it changes the
# result: the Gram and the distances sum each ``_tile_for(d)`` column tile
# and add the tiles in order; the weighted sum takes each worker tile of
# ``DEFAULT_TILE_N`` rows as the reference's compiled code does and adds
# the tiles in order. Zero-padded rows and columns add zeros only, so the
# plain versions leave them out. The tier calls them on more than
# ``MAX_FUSED_WORKERS`` rows only, where the reference's worker tile is
# always ``DEFAULT_TILE_N``; the weighted sum, whose order depends on that
# tile, refuses fewer rows.

def _col_tiles(d: int):
    tile = _tile_for(d)
    return [(a, min(a + tile, d)) for a in range(0, d, tile)]


def pair_gram_blocked_plain(x):
    """(m, m) Gram x xᵀ of a dense (m, d) stack, summed column tile by
    column tile; its upper triangle, mirrored as the kernel mirrors it."""
    x = x.float()
    g = None
    for a, b in _col_tiles(x.shape[1]):
        xk = x[:, a:b]
        g = xk @ xk.T if g is None else g + xk @ xk.T
    return torch.triu(g) + torch.triu(g, 1).T


def sqdist_to_blocked_plain(x, z):
    """(m,) squared distances ‖x_i − z‖², summed column tile by column
    tile."""
    x, z = x.float(), z.float()
    sq = None
    for a, b in _col_tiles(x.shape[1]):
        diff = x[:, a:b] - z[a:b]
        part = (diff * diff).sum(1)
        sq = part if sq is None else sq + part
    return sq


def _giant_rows(who, m: int):
    if m <= MAX_FUSED_WORKERS:
        raise ValueError(
            f"{who} serves the giant-n tier, more than {MAX_FUSED_WORKERS} "
            f"rows; got {m} (fewer rows take the fused kernels)")


def weighted_sum_blocked_plain(x, w):
    """(d,) z = Σ_i w_i·x_i over a dense (m, d) stack, m > 64, worker tile
    by worker tile, the tiles added in order. Each tile's sum is taken as
    the reference's compiled code takes it: the rounded products of its
    ``DEFAULT_TILE_N`` rows (the last tile zero-padded) summed by
    ``xla_sum_rows``."""
    x, w = x.float(), w.float()
    m, tn = x.shape[0], DEFAULT_TILE_N
    _giant_rows("weighted_sum_blocked", m)
    out = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for a in range(0, m, tn):
        prods = list((x[a:a + tn] * w[a:a + tn, None]).unbind(0))
        pad = [torch.zeros_like(prods[0])] * (tn - len(prods))
        out = out + xla_sum_rows(prods + pad)
    return out


def pair_gram_blocked(x):
    """Dense (m, d) float32 stack -> (m, m) float32 Gram, m unbounded. CPU
    tensors take the plain version; CUDA tensors the kernel."""
    pair_gram_blocked.calls += 1
    if _launch.on_cpu("pair_gram_blocked", x.device):
        return pair_gram_blocked_plain(x)
    return _launch_pair_gram_blocked(x)


def sqdist_to_blocked(x, z):
    """Dense (m, d) float32 stack, z (d,) -> (m,) float32 ‖x_i − z‖². CPU
    tensors take the plain version; CUDA tensors the kernel."""
    sqdist_to_blocked.calls += 1
    if _launch.on_cpu("sqdist_to_blocked", x.device):
        return sqdist_to_blocked_plain(x, z)
    return _launch_sqdist_to_blocked(x, z)


def weighted_sum_blocked(x, w):
    """Dense (m, d) float32 stack, m > 64, w (m,) -> (d,) float32
    Σ_i w_i·x_i. CPU tensors take the plain version; CUDA tensors the
    kernel."""
    weighted_sum_blocked.calls += 1
    if _launch.on_cpu("weighted_sum_blocked", x.device):
        return weighted_sum_blocked_plain(x, w)
    return _launch_weighted_sum_blocked(x, w)


for _fn in (pair_gram_blocked, sqdist_to_blocked, weighted_sum_blocked):
    _fn.calls = _fn.launches = 0

_SMS = 132                    # the card's streaming multiprocessors
_GRAM_TILE = 128              # the Gram kernel's output tile, one block an SM
_GRAM_PART = 128 * 136        # entries of a chunk's partial tile (padded rows)
_SQDIST_ROWS = 8              # rows of a sqdist block, a warp each
_SQDIST_BLOCKS = 64 * _SMS    # 256 threads each: some ten waves
_WORKSPACE_BYTES = 256 << 20
_FINISH_GROUP = 16            # as csrc/finish.cuh
_FINISH_TICKETS = 4096


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _finish_groups(chunks: int) -> int:
    return _cdiv(chunks, _FINISH_GROUP)


def finish_fits(units: int, chunks: int, entries: int) -> bool:
    """Whether ``units`` units of ``chunks`` chunks of ``entries`` partial
    sums fit the one-launch finish (``blocks_finish``, csrc/finish.cuh):
    their tickets in the per-stream buffer and their (units, chunks +
    groups, entries) workspace under 256 MB. One chunk needs neither."""
    groups = _finish_groups(chunks)
    return chunks == 1 or (
        units * (groups + 1) <= _FINISH_TICKETS
        and units * (chunks + groups) * entries * 4 <= _WORKSPACE_BYTES)


@functools.lru_cache(maxsize=None)
def gram_plan(m: int, d: int):
    """(chunks, columns per chunk, column tile) of ``pair_gram_blocked``'s
    kernel: one block, alone on an SM, for each 128-row tile pair (i <= j)
    and chunk of whole column tiles (``_tile_for(d)`` columns, the
    reference's, which the plain version sums one by one). The chunks are
    the fewest among those whose blocks best fill the waves they take on
    the card (within 1%), and their finish fits (``finish_fits``)."""
    nt = _cdiv(m, _GRAM_TILE)
    pairs = nt * (nt + 1) // 2
    tile = _tile_for(d)
    n_tiles = _cdiv(d, tile)
    best, best_fill = n_tiles, 0.0
    for per in range(n_tiles, 0, -1):
        chunks = _cdiv(n_tiles, per)
        if not finish_fits(pairs, chunks, _GRAM_PART):
            break
        fill = pairs * n_tiles / (_cdiv(pairs * chunks, _SMS) * _SMS * per)
        if fill > best_fill * 1.01:
            best, best_fill = per, fill
    return _cdiv(n_tiles, best), best * tile, tile


def sqdist_plan(m: int, d: int):
    """(chunks, columns per chunk) of ``sqdist_to_blocked``'s kernel: one
    warp per row and chunk, chunks of whole 128-column steps, enough for
    some ten waves of blocks on the card (so that the last, partial wave
    costs little) where their finish fits."""
    rows = _cdiv(m, _SQDIST_ROWS)
    chunks = max(1, min(_cdiv(_SQDIST_BLOCKS, rows), _cdiv(d, 1024)))
    if not finish_fits(rows, chunks, _SQDIST_ROWS):
        chunks = 1
    cols = _cdiv(_cdiv(d, chunks), 128) * 128
    return _cdiv(d, cols), cols


def _lib_blocked():
    lib = _build.load("norm_agg_blocked")
    if lib.pair_gram_blocked_launch.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.finish_tickets.argtypes = []
        lib.pair_gram_blocked_launch.argtypes = [p, q, q, i, q, q, p, p, p,
                                                 p]
        lib.tf32_tile_launch.argtypes = [p, p, i, p, p]
        lib.sqdist_to_blocked_launch.argtypes = [p, p, q, q, i, q, p, p, p,
                                                 p]
        lib.weighted_sum_blocked_launch.argtypes = [p, p, q, q, p, p]
        for fn in (lib.finish_tickets, lib.pair_gram_blocked_launch,
                   lib.tf32_tile_launch, lib.sqdist_to_blocked_launch,
                   lib.weighted_sum_blocked_launch):
            fn.restype = ctypes.c_int
    return lib


def _chunk_finish(lib, units, chunks, entries, device, stream):
    """(workspace, tickets pointer) of a blocked launch split into chunks:
    (units, chunks + groups, entries) float32 and the stream's tickets;
    (None, None) for one chunk, which writes its result at once."""
    if chunks == 1:
        return None, None
    part = torch.empty(units, chunks + _finish_groups(chunks), entries,
                       dtype=torch.float32, device=device)
    return part, _tickets(lib, device, stream)


def _launch_pair_gram_blocked(x):
    m, d, xp = _launch.dense_args("pair_gram_blocked", x)
    lib = _lib_blocked()
    chunks, cols, tile = gram_plan(m, d)
    nt = _cdiv(m, _GRAM_TILE)
    st = _launch.stream(x.device)
    part, tickets = _chunk_finish(lib, nt * (nt + 1) // 2, chunks,
                                  _GRAM_PART, x.device, st)
    out = torch.empty(m, m, dtype=torch.float32, device=x.device)
    err = lib.pair_gram_blocked_launch(
        xp, m, d, chunks, cols, tile, None if part is None else
        part.data_ptr(), out.data_ptr(), tickets, st)
    _launch.raise_on("pair_gram_blocked", err)
    pair_gram_blocked.launches += 1
    return out


def tf32_tile(a, b):
    """(64, 128) a bᵀ of a (64, k) and b (128, k) float32 CUDA tensors,
    k in {8, 16, 24, 32}, by the Gram kernel's tensor-core product alone
    (one warpgroup, TF32 operands: each value's low 13 mantissa bits are
    dropped), for tests on the card."""
    k = a.shape[1]
    if k not in (8, 16, 24, 32):
        raise ValueError(f"tf32_tile: k must be 8, 16, 24 or 32, got {k}")
    ap = _launch.check("tf32_tile", "a", a, a.device, torch.float32, (64, k))
    bp = _launch.check("tf32_tile", "b", b, a.device, torch.float32,
                       (128, k))
    out = torch.empty(64, 128, dtype=torch.float32, device=a.device)
    err = _lib_blocked().tf32_tile_launch(ap, bp, k // 8, out.data_ptr(),
                                          _launch.stream(a.device))
    _launch.raise_on("tf32_tile", err)
    return out


def _launch_sqdist_to_blocked(x, z):
    m, d, xp = _launch.dense_args("sqdist_to_blocked", x)
    zp = _launch.check("sqdist_to_blocked", "z", z, x.device, torch.float32,
                       (d,))
    lib = _lib_blocked()
    chunks, cols = sqdist_plan(m, d)
    st = _launch.stream(x.device)
    part, tickets = _chunk_finish(lib, _cdiv(m, _SQDIST_ROWS), chunks,
                                  _SQDIST_ROWS, x.device, st)
    out = torch.empty(m, dtype=torch.float32, device=x.device)
    err = lib.sqdist_to_blocked_launch(
        xp, zp, m, d, chunks, cols, None if part is None else
        part.data_ptr(), out.data_ptr(), tickets, st)
    _launch.raise_on("sqdist_to_blocked", err)
    sqdist_to_blocked.launches += 1
    return out


def _launch_weighted_sum_blocked(x, w):
    m, d, xp = _launch.dense_args("weighted_sum_blocked", x)
    _giant_rows("weighted_sum_blocked", m)
    wp = _launch.check("weighted_sum_blocked", "w", w, x.device,
                       torch.float32, (m,))
    lib = _lib_blocked()
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    err = lib.weighted_sum_blocked_launch(xp, wp, m, d, out.data_ptr(),
                                          _launch.stream(x.device))
    _launch.raise_on("weighted_sum_blocked", err)
    weighted_sum_blocked.launches += 1
    return out


# ---------------------------------------------------------------------------
# blocked rule drivers (giant n; dense segments, prologue already applied)
# ---------------------------------------------------------------------------

def rfa_segments_blocked(segs, *, iters: int = 8, eps: float = 1e-8,
                         bvalid=None, return_info: bool = False):
    """Giant-n smoothed Weiszfeld over dense (m, d_j) segments with global
    distances, ``Aggregator._rfa_tree``'s semantics (``_rfa_masked``'s
    with ``bvalid``): per pass one ``weighted_sum_blocked`` (z_t) and one
    ``sqdist_to_blocked`` per segment, then a final weighted sum. Returns
    the per-segment (d_j,) aggregates; nothing is read on the host between
    launches. ``return_info`` as in ``rfa_segments``."""
    m = segs[0].shape[0]
    w = _start_weights(m, bvalid, segs[0].device)
    for _ in range(iters):
        zs = [weighted_sum_blocked(xs, w) for xs in segs]
        sq = sum(sqdist_to_blocked(xs, z) for xs, z in zip(segs, zs))
        w = _next_weights(sq, eps, bvalid)
    outs = [weighted_sum_blocked(xs, w) for xs in segs]
    return (outs, {"bucket_weights": w}) if return_info else outs


def krum_segments_blocked(segs, *, n_byz: int = 1, bvalid=None,
                          return_info: bool = False):
    """Giant-n Krum over dense (m, d_j) segments, ``Aggregator._krum_tree``'s
    semantics (``_krum_masked``'s with ``bvalid``): one
    ``pair_gram_blocked`` per segment (global distances), the scoring
    (``krum_select``), one ``weighted_sum_blocked`` per segment extracting
    the winner through its one-hot. ``return_info`` as in
    ``krum_segments``."""
    g = sum(pair_gram_blocked(xs) for xs in segs)
    onehot, scores, best = krum_select(g, n_byz, bvalid)
    outs = [weighted_sum_blocked(xs, onehot) for xs in segs]
    return (outs, _krum_info(onehot, scores, best)) if return_info else outs
