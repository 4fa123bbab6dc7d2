"""float32 ``log``, ``log1p``, ``exp`` and ``sqrt`` as XLA's CPU backend
emits them, in plain PyTorch.

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
