"""float32 ``log``, ``log1p``, ``exp``, ``expm1``, ``tanh``, ``sqrt``,
``jnp.linspace`` and ``jnp.cumsum`` as XLA's CPU backend emits them, in
plain PyTorch.

The reference's compiled code does not call libm: XLA expands each of
these HLO ops into its own polynomial, and LLVM contracts a product
followed by a sum into one fused multiply-add wherever the product has
no other use. The sequences below were read from the object code XLA
writes for ``jax.jit(jax.scipy.special.erfinv)`` and for the logistic
loss and its gradient (``XLA_FLAGS=--xla_dump_to=...``, the
``*.ir-with-opt.ll`` and ``obj-file.*.o`` of each fusion), and repeat
that arithmetic op for op: every ``fma_f32`` here is a ``vfmadd`` there,
every other product and sum is rounded on its own, and a subnormal
result is flushed to zero as XLA's code flushes it. Where libm and XLA
disagree by an ulp (about 1 input in 7 for ``log``, 1 in 12 for
``log1p``), these agree with XLA, so the port's normals and logistic
gradients equal the reference's bit for bit. ``xla_sum_lanes`` sums a
lane axis in the order XLA's CPU reductions take.
"""
from __future__ import annotations

import struct

import torch
import torch.nn.functional as F

from repro_torch.core.attacks import fma_f32

# XLA on the CPU rewrites a reduction over more rows than this into
# windows of this many rows (its tree-reduction rewrite)
XLA_REDUCE_WINDOW = 32




def _f32(bits64: int) -> float:
    """The float32 constant that LLVM's IR prints as the double ``bits64``."""
    return struct.unpack("<d", struct.pack("<Q", bits64))[0]


def _c(x, v: float):
    return torch.full((), v, dtype=torch.float32, device=x.device)


def ftz(x):
    """x with subnormals flushed to a zero of their sign: XLA's CPU code
    runs with denormals flushed to zero (MXCSR FTZ and DAZ)."""
    return torch.where(x.abs() < 2.0 ** -126, x * 0.0, x)


_SQRT_HALF = _f32(0x3FE6A09E60000000)
_LOG_P = [_f32(b) for b in (
    0x3FB2043760000000, 0xBFBD7A3700000000, 0x3FBDE4A340000000,
    0xBFBFCBA9E0000000, 0x3FC23D37E0000000, 0xBFC555CA00000000,
    0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FD5555540000000)]
_LOG_Q1 = _f32(0xBF2BD01060000000)       # -2.12194440e-4
_LOG_Q2 = _f32(0x3FE6300000000000)       # 0.693359375


def log(a):
    """float32 natural log, XLA's ``log`` (a Cephes-style polynomial on
    the mantissa in [sqrt(1/2), sqrt(2)), the exponent added in two
    parts)."""
    a = ftz(a.float())
    big = torch.where(a > 2.0 ** -126, a, _c(a, 2.0 ** -126))
    bits = big.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    lt = m < _SQRT_HALF
    e = torch.where(lt, e - 1.0, e)
    xm = (m + -1.0) + torch.where(lt, m, _c(m, 0.0))
    z = xm * xm
    x3 = z * xm
    p = [_c(a, v) for v in _LOG_P]
    a1 = fma_f32(xm, fma_f32(xm, p[0], p[1]), p[2])
    b1 = fma_f32(xm, fma_f32(xm, p[3], p[4]), p[5])
    c1 = fma_f32(xm, fma_f32(xm, p[6], p[7]), p[8])
    y = fma_f32(x3, fma_f32(x3, fma_f32(x3, a1, b1), c1), e * _LOG_Q1)
    s = fma_f32(_c(a, -0.5), z, xm) + y
    out = fma_f32(e, _c(a, _LOG_Q2), s)
    out = torch.where((a > 0) & (a < float("inf")), out, _c(a, float("nan")))
    out = torch.where(a == 0, _c(a, float("-inf")), out)
    return torch.where(a == float("inf"), a, out)


_LOG1P_SMALL = _f32(0x3FDA8279A0000000)  # sqrt(2) - 1
_LOG1P_Q = [_f32(b) for b in (
    0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
    0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000)]
_LOG1P_P = [_f32(b) for b in (
    0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
    0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
    0x40340A2020000000)]


def log1p(t):
    """float32 log(1 + t), XLA's ``log-plus-one``: t + t³·P(t)/Q(t) −
    t²/2 where |t| < sqrt(2) − 1, else ``log(1 + t)``."""
    t = ftz(t.float())
    t2 = t * t
    t0 = t * 0.0
    q = t0 + 1.0
    for v in _LOG1P_Q:
        q = fma_f32(q, t, _c(t, v))
    p = t0 + _LOG1P_P[0]
    for v in _LOG1P_P[1:]:
        p = fma_f32(p, t, _c(t, v))
    v = (t * t2) * (p / q)
    small = t + fma_f32(_c(t, -0.5), t2, v)
    return ftz(torch.where(t.abs() < _LOG1P_SMALL, small, log(t + 1.0)))


_EXP_LO = _f32(0xC055F33340000000)       # -87.8
_EXP_HI = _f32(0x4056333340000000)       # 88.8
_LOG2E = _f32(0x3FF7154760000000)
_EXP_P = [_f32(b) for b in (
    0x3F2A0D2CE0000000, 0x3F56E879C0000000, 0x3F81112100000000,
    0x3FA5553820000000, 0x3FC5555540000000)] + [0.5]


def exp(x):
    """float32 e^x, XLA's ``exponential`` (Cephes' expf: n = ⌊x·log2e +
    ½⌋ clamped to ±127, r = x − n·ln2 in two parts, a degree-5
    polynomial, times 2^n built in the exponent bits)."""
    x = x.float()
    x = torch.where(x < _EXP_LO, _c(x, _EXP_LO), x)
    x = torch.where(x > _EXP_HI, _c(x, _EXP_HI), x)
    n = torch.floor(fma_f32(x, _c(x, _LOG2E), _c(x, 0.5)))
    n = n.clamp(-127.0, 127.0)
    r = fma_f32(-n, _c(x, _LOG_Q2), x)
    r = fma_f32(-n, _c(x, _LOG_Q1), r)
    y = fma_f32(r, _c(x, _EXP_P[0]), _c(x, _EXP_P[1]))
    for v in _EXP_P[2:]:
        y = fma_f32(y, r, _c(x, v))
    y = fma_f32(y, r * r, r) + 1.0
    scale = ((torch.nan_to_num(n).int() + 127) << 23).view(torch.float32)
    return ftz(y * scale)


_TANH_SMALL = _f32(0x3F3A36E2E0000000)  # 4e-4: tanh(x) = x below it
_TANH_CLAMP = _f32(0x401FFEC880000000)  # 7.9988...: tanh is ±1 in float32
_TANH_P = [_f32(b) for b in (
    0xBCB3E4B800000000, 0x3D4C266FC0000000, 0xBDD7A6FFE0000000,
    0x3E6B800820000000, 0x3EEF286940000000, 0x3F44E1BDA0000000,
    0x3F740B3B80000000)]
_TANH_Q = [_f32(b) for b in (
    0x3EB41A7B00000000, 0x3F1F12BAC0000000, 0x3F629540A0000000,
    0x3F740B3BA0000000)]


def tanh(x):
    """float32 tanh, XLA's (Eigen's rational approximation): x·P(x²)/Q(x²)
    on x clamped to ±7.9988, x itself where |x| < 4e-4, ±1 where |x| ≥
    20. Where it returns x itself, a subnormal x stays (a select moves its
    bits; only arithmetic flushes)."""
    raw = x.float()
    x = ftz(raw)
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    p = _c(x, _TANH_P[0])
    for v in _TANH_P[1:]:
        p = fma_f32(x2, p, _c(x, v))
    q = _c(x, _TANH_Q[0])
    for v in _TANH_Q[1:]:
        q = fma_f32(x2, q, _c(x, v))
    out = ftz((xc * p) / q)
    out = torch.where(x.abs() < _TANH_SMALL, raw, out)
    return torch.where(x.abs() >= 20.0, torch.sign(x), out)


def expm1(x):
    """float32 e^x − 1, XLA's ``exponential-minus-one``: ``exp(x) − 1``
    where |x| > ½, else tanh(x/2)·(exp(x) + 1) with XLA's tanh, and x
    itself where x/2 is zero; neither sum is fused with exp's last
    product, which has two uses."""
    raw = x.float()
    x = ftz(raw)
    e = exp(x)
    h = ftz(x * 0.5)
    out = ftz(torch.where(x.abs() > 0.5, e - 1.0, tanh(h) * (e + 1.0)))
    return torch.where(h == 0, raw, out)


# a linspace of more than this many steps stays a loop in XLA's CPU code;
# up to it LLVM unrolls the loop and folds each 1 - i/div into a constant
_LINSPACE_UNROLL = 351
_LINSPACE_BLOCK = 32               # entries a vectorized iteration


def linspace(start: float, stop: float, num: int, device=None):
    """float32 ``jnp.linspace(start, stop, num)`` as its compiled code
    computes it on the CPU. XLA turns ``i / div`` (div = num − 1) into a
    product with the rounded reciprocal c and hoists ``stop · c``; each
    entry is then start·(1 − i·c) + i·(stop·c), ``stop`` appended. In the
    loop, 1 − i·c is one fused multiply-add and so is the final sum;
    where LLVM unrolled the loop (up to _LINSPACE_UNROLL steps, and the
    remainder past the last whole block of _LINSPACE_BLOCK above it) it
    folded 1 − i·c into a constant with two roundings, and in a loop of
    under _LINSPACE_BLOCK steps i = 1's product i·(stop·c) folds to
    stop·c, so that entry fuses the other product. Equal to
    ``jnp.linspace`` bit for bit up to 4096 entries
    (``tests/test_torch_xla_math.py``)."""
    f = dict(dtype=torch.float32, device=device)
    s, e = torch.tensor(start, **f), torch.tensor(stop, **f)
    if num <= 1:
        return s.reshape(1)[:num]
    div = num - 1
    i = torch.arange(div, **f)
    c = torch.tensor(1.0, **f) / div
    sc = e * c
    folded = (1.0 - i * c) if div <= _LINSPACE_UNROLL else torch.where(
        torch.arange(div, device=device) < div // _LINSPACE_BLOCK
        * _LINSPACE_BLOCK, fma_f32(-i, c.expand(div), _c(i, 1.0)),
        1.0 - i * c)
    out = fma_f32(i, sc.expand(div), s * folded)
    if 1 < div < _LINSPACE_BLOCK:
        out[1] = fma_f32(s, folded[1], sc)
    return torch.cat([out, e.reshape(1)])


# XLA on the CPU rewrites a cumulative sum over more entries than this
# into blocks of this many and a cumulative sum of the blocks' totals
XLA_SCAN_BLOCK = 16


def cumsum(x, dim: int):
    """Cumulative sum along ``dim`` in the order of ``jnp.cumsum``'s
    compiled code on the CPU: in order within blocks of XLA_SCAN_BLOCK
    (the last padded with zeros), then each block's running totals,
    summed the same way, added to it. ``torch.cumsum`` accumulates in
    float64 on the CPU and parts from it by an ulp or two. Plain ops, so
    autograd (the gradient a plain reverse sum) and vmap run through it."""
    return _blocked_cumsum(x.movedim(dim, -1)).movedim(-1, dim)


def _blocked_cumsum(x):
    n, blk = x.shape[-1], XLA_SCAN_BLOCK
    if n <= blk:
        return _running_sum(x)
    m = -(-n // blk) * blk
    local = _running_sum(F.pad(x, (0, m - n)).reshape(
        x.shape[:-1] + (m // blk, blk)))
    prefix = F.pad(_blocked_cumsum(local[..., -1])[..., :-1], (1, 0))
    return (local + prefix[..., None]).reshape(x.shape[:-1] + (m,))[..., :n]


def _running_sum(x):
    """Σ x[..., :i+1] for each i, added one entry at a time."""
    cols = x.unbind(-1)
    acc = [cols[0]]
    for c in cols[1:]:
        acc.append(acc[-1] + c)
    return torch.stack(acc, -1)


def sqrt(x):
    """Correctly rounded float32 square root (``vsqrtps``); PyTorch's CPU
    kernel is not correctly rounded for every input, a float64 root
    rounded to float32 is."""
    return x.double().sqrt().float()


def xla_sum_lanes(x):
    """Σ over the last axis of a float32 tensor in the order of
    ``core.aggregators.xla_sum_rows`` (XLA on the CPU reduces a lane axis
    in the same windows of XLA_REDUCE_WINDOW),
    vectorized over the windows, so a leaf of millions of coordinates
    sums in a few passes."""
    width = x.shape[-1]
    if width > XLA_REDUCE_WINDOW:
        k = -(-width // XLA_REDUCE_WINDOW)
        lo = (k * XLA_REDUCE_WINDOW - width) // 2
        x = F.pad(x, (lo, k * XLA_REDUCE_WINDOW - width - lo))
        x = xla_sum_lanes(x.reshape(x.shape[:-1] + (k, XLA_REDUCE_WINDOW)))
        return xla_sum_lanes(x)
    acc = x[..., 0]
    for i in range(1, width):
        acc = acc + x[..., i]
    return acc
