"""Wire formats for the one-sweep compressed pipeline and the block
quantizer (port of ``repro/kernels/quantize.py``).

Payload of one leaf, worker-stacked (every array (n, ...)):

* ``sparse`` — vals (n, k) float32 and idx (n, k) int32, ascending per
  worker row (RandK keeps the d/k scaling in vals, TopK sends them raw);
* ``int8``   — lev (n, nb·256) int8 levels and norms (n, nb) float32, one
  ℓ2 norm per block of ``INT8_BLOCK`` coordinates (the tail zero-padded);
* ``sign``   — signs (n, d) int8 and scale (n, 1) float32;
* ``bf16``   — vals (n, d) bfloat16.

The CUDA aggregation kernels rebuild each tile of the candidates from it
in their shared load (``csrc/agg_prologue.cuh``): the sparse wire through
a search of each worker's ascending idx row on the card
(``sparse_range_start`` is its plain twin; ``wire_starts``, the CSR row
pointers, is the oracle its tests hold it to), the other three
elementwise, so the dense (n, d) candidate matrix never exists in device
memory. ``decode``
and ``recon`` are the plain reconstruction the CPU path and the tests
use.

Two kernels live here, each with its plain PyTorch version beside it
(taken for CPU tensors only; a CUDA tensor launches the kernel or raises):

* ``topk_select``    — TopK's selection, batched over workers: an exact
                       radix select of each row's threshold and an
                       ordered compaction of its support
                       (``csrc/topk_select.cu``; ``topk_support``, the
                       sparse wire's ascending indices), ordered by
                       descending |x| for ``topk_select`` (a stable sort
                       of the k values);
* ``block_quantize`` — block-ℓ2 stochastic rounding with the dither
                       supplied (``csrc/block_quantize.cu``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import random as R
from repro_torch.core.attacks import fma_f32
from repro_torch.core.compressors import (INT8_BLOCK, INT8_LEVELS,
                                          _int8_encode, _rcp, block_norms,
                                          int8_products, sign_scale)
from repro_torch.kernels import _build, _launch

WIRE_FORMATS = ("sparse", "int8", "sign", "bf16", "dense32")
TOPK_TILE = 2048         # the reference's column tile (DEFAULT_TILE_D)
QUANT_BLOCK = 256        # coordinates sharing one ℓ2 norm


@dataclasses.dataclass(frozen=True)
class WireSrc:
    """One worker-stacked wire payload standing in for the dense (n, d)
    candidate matrix at a kernel call site. ``arrays`` is a tuple of
    (name, (n, ...) tensor); ``base`` is the reconstruction base added in
    the kernel: (n, d) per-worker state, (1, d) a shared server estimate
    (MARINA's g^k), or None; ``cand_dtype`` the candidates' dtype, which
    the load rounds through (float32 or bfloat16).

    The reference rounds an int8 tile up to whole 256-coordinate blocks
    (``wire_tile``) so that a tile sees whole blocks. The CUDA load has
    no such constraint: column c reads norms[i, c >> 8] directly, so the
    kernels' 128-column tile needs no rounding."""
    fmt: str
    n: int
    d: int
    arrays: tuple
    base: Optional[torch.Tensor] = None
    cand_dtype: torch.dtype = torch.float32

    @property
    def device(self):
        return self.arrays[0][1].device


def pack_sparse(key, x, ratio: float, *, topk: bool):
    """Sparse payload of a leaf: {"vals": (..., k), "idx": (..., k) int32
    ascending}. ``key`` (..., 2) and ``x`` (..., d) share leading axes, so
    one call packs every worker. RandK selects the permutation ``rand_k``
    draws and scales by d/k; TopK sends ``topk_support``'s indices (the
    dense compressor's, in ascending order) and the values raw."""
    d = x.shape[-1]
    k = max(int(ratio * d), 1)
    if topk:
        idx, vals = topk_support(x, k)
        return {"vals": vals.to(x.dtype), "idx": idx}
    sel = R.permutation(key, d)[..., :k]
    idx = torch.sort(sel, dim=-1).values
    vals = (torch.gather(x, -1, idx) * (d / k)).to(x.dtype)
    return {"vals": vals, "idx": idx.to(torch.int32)}


def pack_int8(key, x):
    """{"lev": (..., nb·B) int8, "norms": (..., nb) float32} of a leaf
    (``compressors._int8_encode``); key (..., 2) and x (..., d) share
    leading axes."""
    levels, norms = _int8_encode(key, x)
    return {"lev": levels.flatten(-2), "norms": norms}


def pack_sign(key, x):
    """{"signs": (..., d) int8, "scale": (..., 1) float32 mean |x|}."""
    return {"signs": torch.sign(x.float()).to(torch.int8),
            "scale": sign_scale(x)}


def pack_bf16(key, x):
    """{"vals": (..., d) bfloat16}, rounded to nearest even."""
    return {"vals": x.to(torch.bfloat16)}


PACK = {"int8": pack_int8, "sign": pack_sign, "bf16": pack_bf16}


# ---------------------------------------------------------------------------
# TopK selection
# ---------------------------------------------------------------------------
#
# An exact radix select over each row (``csrc/topk_select.cu``): the key of
# |x| is its float bits with the sign cleared, every NaN one key (above
# +inf); three digits of 11, 10 and 10 bits, from the top, find the k-th
# largest key T and ``need``, how many keys equal to T are kept (the first
# in index order); an ordered compaction keeps every key > T and those, in
# ascending index order: the support of ``lax.top_k(|x|, k)[1]``. Each
# phase has a plain twin here that repeats it step for step.

# (shift, bits) of the three digits, from the top
TOPK_DIGITS = ((20, 11), (10, 10), (0, 10))


def _check_k(d: int, k: int):
    if not 1 <= k <= d:
        raise ValueError(f"topk_select: k={k} outside [1, {d}]")


def _stable_top(a, k: int):
    """Positions of the k largest entries along the last axis, largest
    first, equal entries in position order (``lax.top_k``'s order)."""
    return torch.sort(a, dim=-1, descending=True, stable=True).indices[..., :k]


def topk_keys(x):
    """The select's int32 keys of |x|: the bits of the float32 |x| (its
    sign cleared), an order-preserving integer, with every NaN one key
    (0x7FC00000, above +inf's), so that NaNs tie as the stable sort ties
    them."""
    u = x.float().contiguous().view(torch.int32) & 0x7FFFFFFF
    return torch.where(u > 0x7F800000, 0x7FC00000, u)


def topk_threshold_plain(x, k: int):
    """The radix select's threshold per row of x (rows, d), the kernels'
    digit passes step for step: at each digit a histogram over the keys
    that share the digits found so far, then the digit where the count
    from the top reaches ``need`` (k at first). Returns (T, G, need):
    the k-th largest key (int64), the keys above it and k − G, the keys
    equal to T that the selection keeps."""
    keys = topk_keys(x).long()
    rows = keys.shape[0]
    prefix = torch.zeros(rows, dtype=torch.int64, device=x.device)
    need = torch.full((rows,), k, dtype=torch.int64, device=x.device)
    for shift, bits in TOPK_DIGITS:
        hi = shift + bits
        inside = (keys >> hi) == (prefix >> hi)[:, None]
        digit = (keys >> shift) & ((1 << bits) - 1)
        hist = torch.zeros(rows, 1 << bits, dtype=torch.int64,
                           device=x.device).scatter_add_(1, digit,
                                                         inside.long())
        above = hist.flip(1).cumsum(1).flip(1) - hist     # digits above b
        hit = (above < need[:, None]) & (above + hist >= need[:, None])
        b = hit.long().argmax(1)
        need = need - above.gather(1, b[:, None])[:, 0]
        prefix = prefix | (b << shift)
    return prefix, k - need, need


def topk_compact_plain(x, k: int):
    """The ordered compaction's twin on x (rows, d): every key > T and the
    first ``need`` keys == T, in ascending index order -> (idx (rows, k)
    int32, x at idx (rows, k) float32)."""
    rows, d = x.shape
    _check_k(d, k)
    t, _, need = topk_threshold_plain(x, k)
    keys = topk_keys(x).long()
    eq = keys == t[:, None]
    keep = (keys > t[:, None]) | (eq & (eq.long().cumsum(1) <= need[:, None]))
    idx = keep.nonzero()[:, 1].reshape(rows, k)
    return idx.int(), torch.gather(x.float(), 1, idx)


def _rows(x, k: int):
    """x (..., d) as contiguous float32 rows (rows, d), after checking k."""
    d = x.shape[-1]
    _check_k(d, k)
    return x.reshape(-1, d).float().contiguous()


def _support(x, k: int, plain: bool):
    """(idx (..., k) int32 ascending, x at idx float32) of the k largest
    |x| along the last axis. Up to two tiles wide the plain sort runs
    alone, as in the reference; wider rows take the radix select: the
    kernels on a CUDA tensor (unless ``plain``), the twins on a CPU one."""
    lead, d = x.shape[:-1], x.shape[-1]
    rows = _rows(x, k)
    if d <= 2 * TOPK_TILE:
        idx = torch.sort(_stable_top(rows.abs(), k), dim=-1).values
        idx, vals = idx.int(), torch.gather(rows, -1, idx)
    elif plain or _launch.on_cpu("topk_select", x.device):
        idx, vals = topk_compact_plain(rows, k)
    else:
        idx, vals = _launch_topk(rows, k)
    return idx.reshape(lead + (k,)), vals.reshape(lead + (k,))


def _descending(idx, vals, k: int):
    """The support reordered as ``lax.top_k`` orders it: a stable
    descending sort of the k |values| (equal values keep their ascending
    index order)."""
    return torch.gather(idx, -1, _stable_top(vals.abs(), k))


def _select(x, k: int, plain: bool):
    """``lax.top_k(|x|, k)[1]`` along the last axis: the plain sort up to
    two tiles wide; wider, the support in descending order."""
    lead, d = x.shape[:-1], x.shape[-1]
    rows = _rows(x, k)
    if d <= 2 * TOPK_TILE:
        idx = _stable_top(rows.abs(), k).int()
    elif plain or _launch.on_cpu("topk_select", x.device):
        idx = _descending(*topk_compact_plain(rows, k), k)
    else:
        idx = _descending(*_launch_topk(rows, k), k)
    return idx.reshape(lead + (k,))


def topk_support(x, k: int):
    """TopK's support: (..., d) -> (idx, vals), the (..., k) int32
    indices of the k largest |x|, ascending (the sparse wire's order),
    equal to ``torch.sort(topk_select_plain(x, k)).values``, and x at
    them as float32. On CUDA tensors wider than two tiles the select
    kernels run, one pipeline for all rows; CPU tensors take the twins."""
    topk_select.calls += 1
    return _support(x, k, plain=False)


def topk_support_plain(x, k: int):
    """``topk_support`` on the plain twins, on any device."""
    return _support(x, k, plain=True)


def topk_select(x, k: int):
    """TopK's indices: (..., d) -> (..., k) int32 of the k largest |x|,
    largest first, ties to the lower index (``lax.top_k(|x|, k)[1]``):
    ``topk_support`` in descending order, the counterpart of the
    reference's ``lax.top_k`` over its pool (``_select``). CPU tensors
    take the plain version."""
    topk_select.calls += 1
    return _select(x, k, plain=False)


def topk_select_plain(x, k: int):
    """``topk_select`` on the plain twins, on any device."""
    return _select(x, k, plain=True)


# calls: every TopK selection, through topk_select or topk_support, plain
# or kernel; launches: select pipelines run on the card (one kernel up to
# topk_small_d() columns, a memset and seven kernels above)
topk_select.calls = topk_select.launches = 0


def _lib_topk():
    lib = _build.load("topk_select")
    if lib.topk_support_launch.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.topk_small_d.argtypes = []
        lib.topk_small_d.restype = i
        lib.topk_workspace_bytes.argtypes = [q, q]
        lib.topk_workspace_bytes.restype = q
        lib.topk_support_launch.argtypes = [p, q, q, i, p, p, p, p]
        lib.topk_support_launch.restype = i
    return lib


def _launch_topk(x, k: int):
    """The select kernels on x (rows, d) float32 -> (idx, vals), the
    support ascending."""
    if x.dim() != 2 or x.shape[1] <= 2 * TOPK_TILE:
        raise ValueError("topk_select kernel: x must be (rows, d) with d > "
                         f"{2 * TOPK_TILE}, got shape {tuple(x.shape)}")
    rows, d = x.shape
    if d >= 1 << 31:
        raise ValueError(f"topk_select kernel: d={d} needs int64 indices")
    xp = _launch.check("topk_select", "x", x, x.device, torch.float32,
                       (rows, d))
    lib = _lib_topk()
    work = None
    if d > lib.topk_small_d():
        work = torch.empty(lib.topk_workspace_bytes(rows, d),
                           dtype=torch.uint8, device=x.device)
    idx = torch.empty(rows, k, dtype=torch.int32, device=x.device)
    vals = torch.empty(rows, k, dtype=torch.float32, device=x.device)
    err = lib.topk_support_launch(xp, rows, d, k,
                                  None if work is None else work.data_ptr(),
                                  idx.data_ptr(), vals.data_ptr(),
                                  _launch.stream(x.device))
    _launch.raise_on("topk_select", err)
    topk_select.launches += 1
    return idx, vals


# ---------------------------------------------------------------------------
# block quantizer
# ---------------------------------------------------------------------------

def block_quantize_plain(x, u, *, levels: int = 4):
    """Plain version of the block quantizer: x, u (d,) -> (d,) float32.
    Per block of ``QUANT_BLOCK`` coordinates (the tail zero-padded):
    norm = sqrt(Σ x²) (``block_norms``);
    level = floor(|x|/max(norm, 1e-30)·s + u)
    (0 where norm = 0); out = norm·sign(x)·level times the rounded 1/s
    (XLA turns the division by the constant s into that product)."""
    d = x.shape[0]
    pad = (-d) % QUANT_BLOCK
    xb = F.pad(x.float(), (0, pad)).reshape(-1, QUANT_BLOCK)
    ub = F.pad(u.float(), (0, pad)).reshape(-1, QUANT_BLOCK)
    norm = block_norms(xb)
    scaled = torch.where(norm > 0, xb.abs() / torch.clamp(norm, min=1e-30),
                         torch.zeros((), device=x.device))
    level = torch.floor(scaled * levels + ub)
    inv = torch.ones((), device=x.device) / levels
    return (norm * torch.sign(xb) * level * inv).reshape(-1)[:d]


def block_quantize(x, u, *, levels: int = 4):
    """Block-ℓ2 stochastic rounding of x (d,) with the dither u (d,), both
    read as float32 -> (d,) float32 (``block_quantize_plain``). CPU
    tensors take the plain version; CUDA tensors the kernel."""
    if _launch.on_cpu("block_quantize", x.device):
        return block_quantize_plain(x, u, levels=levels)
    return _launch_block_quantize(x.float().contiguous(),
                                  u.float().contiguous(), levels)


block_quantize.launches = 0


def _lib_quant():
    lib = _build.load("block_quantize")
    if lib.block_quantize_launch.argtypes is None:
        p = ctypes.c_void_p
        lib.block_quantize_launch.argtypes = [p, p, ctypes.c_longlong,
                                              ctypes.c_int, p, p]
        lib.block_quantize_launch.restype = ctypes.c_int
    return lib


def _launch_block_quantize(x, u, levels: int):
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError("block_quantize kernel: x must be a non-empty (d,) "
                         f"vector, got shape {tuple(x.shape)}")
    if levels < 1:
        raise ValueError(f"block_quantize kernel: levels={levels}")
    d = x.shape[0]
    xp = _launch.check("block_quantize", "x", x, x.device, torch.float32,
                       (d,))
    up = _launch.check("block_quantize", "u", u, x.device, torch.float32,
                       (d,))
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    err = _lib_quant().block_quantize_launch(xp, up, d, int(levels),
                                             out.data_ptr(),
                                             _launch.stream(x.device))
    _launch.raise_on("block_quantize", err)
    block_quantize.launches += 1
    return out


def decode(fmt: str, payload: dict, d: int):
    """Payload (worker-stacked or one worker) -> dense (..., d) float32.
    The int8 levels take XLA's compiled division by 127, a product with
    the rounded reciprocal (``compressors._int8_decode``)."""
    if fmt == "int8":
        prod, rcp = int8_parts(payload, d)
        return prod * rcp
    if fmt == "sign":
        return payload["signs"].float() * payload["scale"]
    if fmt == "bf16":
        return payload["vals"].float()
    if fmt != "sparse":
        raise ValueError(fmt)
    vals = payload["vals"].float()
    idx = payload["idx"].long()
    # the reference's scatter (mode="drop"): a negative index counts from
    # the end, and one still outside [0, d) is dropped (a garbled payload)
    idx = torch.where(idx < 0, idx + d, idx)
    idx = torch.where((idx >= 0) & (idx < d), idx, d)
    out = torch.zeros(vals.shape[:-1] + (d + 1,), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_(-1, idx, vals)[..., :d]


def int8_parts(payload: dict, d: int):
    """(norm·level (..., d), the rounded 1/127) of an int8 payload: its
    decode is their product, which XLA fuses into a following add."""
    norms = payload["norms"]
    lev = payload["lev"]
    lev = lev.reshape(lev.shape[:-1] + (norms.shape[-1], INT8_BLOCK))
    return (int8_products(lev, norms)[..., :d],
            _rcp(INT8_LEVELS).to(norms.device))


def recon_rows(fmt: str, payload: dict, d: int, base, cand_dtype):
    """Decode, round-trip through the candidate dtype, add the base of 0,
    1 or n rows, round-trip again -> (n, d) float32 (``recon_block``).
    On a float32 int8 payload with a base, XLA fuses the decode's last
    product into the base add: norm·level·(1/127) + base is one fused
    multiply-add."""
    if (fmt == "int8" and base is not None
            and cand_dtype == torch.float32):
        prod, rcp = int8_parts(payload, d)
        return fma_f32(prod, rcp, base.float())
    q = decode(fmt, payload, d).to(cand_dtype).float()
    if base is None:
        return q
    return (q + base.float()).to(cand_dtype).float()


def recon(src: WireSrc):
    """Plain reconstruction of a WireSrc (``recon_rows``) -> (n, d)
    float32."""
    return recon_rows(src.fmt, dict(src.arrays), src.d, src.base,
                      src.cand_dtype)


def wire_starts(idx, d: int, tile: int):
    """(n, T + 1) int32 CSR row pointers over T = ceil(d / tile) tiles: row
    i's entries for tile t are positions [starts[i, t], starts[i, t + 1])
    of its ascending int32 idx row (a searchsorted per worker)."""
    n_tiles = -(-d // tile)
    bounds = torch.arange(n_tiles + 1, dtype=torch.int32,
                          device=idx.device) * tile
    bounds = bounds.expand(idx.shape[0], n_tiles + 1).contiguous()
    return torch.searchsorted(idx, bounds, out_int32=True)


def sparse_range_start(idx_row, target: int) -> int:
    """First position p of an ascending int32 row with idx_row[p] >=
    target, or its length: the plain twin of the looping kernels' warp
    search (``warp_lower_bound2`` in ``csrc/agg_prologue.cuh``), step for
    step: 32 probes at lo + ⌊span·(l+1)/33⌋ while the range is wider than
    32, then the last ≤ 32 positions. ``idx_row``: a 1-D tensor or a
    list."""
    row = idx_row.tolist() if torch.is_tensor(idx_row) else idx_row
    lo, hi = 0, len(row)
    while hi - lo > 32:
        span = hi - lo
        c = sum(row[lo + span * (lane + 1) // 33] < target
                for lane in range(32))
        nlo = lo if c == 0 else lo + span * c // 33 + 1
        if c < 32:
            hi = lo + span * (c + 1) // 33
        lo = nlo
    return lo + sum(row[p] < target for p in range(lo, hi))


def sparse_bounds_plain(idx, d: int, group: int, blocks: int):
    """(blocks, n) int32: for each block of a looping kernel that splits
    ⌈d / group⌉ column groups over ``blocks`` blocks, and each worker row,
    where the block's range starts in that row (``sparse_range_start``)."""
    groups = -(-d // group)
    rows = idx.tolist()
    out = [[sparse_range_start(row, groups * b // blocks * group)
            for row in rows] for b in range(blocks)]
    return torch.tensor(out, dtype=torch.int32)


def sparse_bounds(idx, d: int, group: int, blocks: int):
    """The looping kernels' range search alone on the card
    (``sparse_bounds_launch`` in ``csrc/robust_agg.cu``), to hold it
    against ``sparse_bounds_plain``; a CPU tensor takes the plain
    version."""
    if _launch.on_cpu("sparse_bounds", idx.device):
        return sparse_bounds_plain(idx, d, group, blocks)
    n, k = idx.shape
    ip = _launch.check("sparse_bounds", "idx", idx, idx.device, torch.int32,
                       (n, k))
    lib = _build.load("robust_agg")
    if lib.sparse_bounds_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sparse_bounds_launch.argtypes = [p, i, i, ctypes.c_longlong, i,
                                             i, p, p]
        lib.sparse_bounds_launch.restype = ctypes.c_int
    out = torch.empty(blocks, n, dtype=torch.int32, device=idx.device)
    err = lib.sparse_bounds_launch(ip, n, k, d, group, blocks,
                                   out.data_ptr(), _launch.stream(idx.device))
    _launch.raise_on("sparse_bounds", err)
    sparse_bounds.launches += 1
    return out


sparse_bounds.launches = 0
