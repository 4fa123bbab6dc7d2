"""Compression operators (port of ``repro/core/compressors.py``).

Every entry of the reference's registry: ``identity``, ``rand_k``
(per-coordinate selection and the contiguous-block selection above
``_MAX_UNITS`` units), ``top_k``, ``l2_dithering``, ``natural_compression``,
``sign_compressor``, ``int8_quantization`` (blockwise ℓ2 dithering onto
int8 levels) and ``bf16_cast``. ``dither`` and ``natural`` have no kernel
wire (``fallback_only``): their candidates reach the kernels dense.
``CONTRACTIVE`` names the entries with a contraction bound, for
``byz_ef21``'s guard.

The float32 arithmetic is the reference's compiled code's: a sum over a
leaf or a block follows XLA's windows of 32 lanes
(``xla_math.xla_sum_lanes``), a division by a constant is a product
with its rounded reciprocal, the dithers' ``scaled·s + u`` is one fused
multiply-add, and XLA's code runs with subnormals flushed to zero.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch import random as R
from repro_torch import xla_math as X
from repro_torch.xla_math import xla_sum_lanes
from repro_torch.core.attacks import fma_f32


@dataclasses.dataclass(frozen=True)
class Compressor:
    name: str
    compress: Callable          # (key, x) -> dense x_hat
    omega_fn: Callable          # d -> omega
    bits_fn: Callable           # d -> bits on the wire per vector
    density_fn: Callable        # d -> expected nonzeros
    common_randomness: bool = False
    ratio: Optional[float] = None
    contractive_fn: Optional[Callable] = None
    wire_format: Optional[str] = None
    fallback_only: bool = False

    def omega(self, d):
        return self.omega_fn(d)

    def bits_per_vector(self, d):
        return self.bits_fn(d)

    def contractive_delta(self, d) -> Optional[float]:
        """δ_C with E‖C(x) − x‖² <= δ_C ‖x‖² of one applied vector, or
        None without a contraction bound."""
        return None if self.contractive_fn is None else self.contractive_fn(d)

    def tree_bits(self, dims) -> float:
        return float(sum(self.bits_fn(int(d)) for d in dims))


def identity() -> Compressor:
    return Compressor(
        name="identity",
        compress=lambda key, x: x,
        omega_fn=lambda d: 0.0,
        bits_fn=lambda d: 32 * d,
        density_fn=lambda d: d,
        contractive_fn=lambda d: 0.0,
        wire_format="dense32",
    )


_MAX_UNITS = 1 << 22     # selection-unit cap, as in the reference


def unit_partition(d: int):
    """(block_size, n_units) of RandK's selection."""
    blk = max(-(-d // _MAX_UNITS), 1)
    return blk, -(-d // blk)


def rand_k(ratio: float = 0.1, *, common_randomness: bool = False) -> Compressor:
    """RandK: keep K = ratio·units units, scale by units/K (unbiased).
    Units are coordinates for d <= 2^22, contiguous blocks above."""
    if not (0 < ratio <= 1):
        raise ValueError(ratio)

    def compress(key, x):
        d = x.numel()
        blk, n_units = unit_partition(d)
        k_units = max(int(ratio * n_units), 1)
        scale = n_units / k_units
        perm = R.permutation(key, n_units)
        mask = torch.zeros(n_units, dtype=torch.bool, device=x.device)
        mask[perm[:k_units]] = True
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if blk == 1:
            return torch.where(mask.reshape(x.shape), x * scale,
                               zero).to(x.dtype)
        xf = torch.nn.functional.pad(x.reshape(-1), (0, n_units * blk - d))
        out = torch.where(mask[:, None], xf.reshape(n_units, blk) * scale,
                          zero)
        return out.reshape(-1)[:d].reshape(x.shape).to(x.dtype)

    def _selection(d):
        blk, n_units = unit_partition(d)
        return blk, n_units, max(int(ratio * n_units), 1)

    def omega_fn(d):
        _, n_units, k_units = _selection(d)
        return n_units / k_units - 1.0

    def bits_fn(d):
        blk, _, k_units = _selection(d)
        return k_units * (32 * blk + 32)

    def density_fn(d):
        blk, _, k_units = _selection(d)
        return min(k_units * blk, d)

    return Compressor(
        name=f"randk_{ratio}" + ("_cr" if common_randomness else ""),
        compress=compress, omega_fn=omega_fn, bits_fn=bits_fn,
        density_fn=density_fn, common_randomness=common_randomness,
        ratio=ratio, wire_format="sparse")


def top_k(ratio: float = 0.1) -> Compressor:
    """TopK: keep the k = max(int(ratio·d), 1) largest |x_i| of each leaf,
    unscaled — biased and contractive, ‖C(x) − x‖² ≤ (1 − k/d)‖x‖². The
    selection is ``lax.top_k``'s: descending |x|, ties to the lower index
    (a stable descending sort; ``torch.topk`` leaves tie order open)."""
    if not (0 < ratio <= 1):
        raise ValueError(ratio)

    def _k(d):
        return max(int(ratio * d), 1)

    def compress(key, x):
        d = x.numel()
        xf = x.reshape(-1).float()
        idx = torch.sort(xf.abs(), descending=True, stable=True).indices
        mask = torch.zeros(d, dtype=torch.bool, device=x.device)
        mask[idx[:_k(d)]] = True
        out = torch.where(mask, xf, torch.zeros((), device=x.device))
        return out.reshape(x.shape).to(x.dtype)

    return Compressor(
        name=f"topk_{ratio}", compress=compress,
        omega_fn=lambda d: float("nan"),         # biased; no omega
        bits_fn=lambda d: _k(d) * (32 + 32),     # k values + k indices
        density_fn=_k, ratio=ratio,
        contractive_fn=lambda d: 1.0 - _k(d) / d, wire_format="sparse")


def _uniform_like(key, x):
    """U[0, 1) of x's shape on x's device; above 2^26 coordinates drawn in
    chunks of 2^26 under fold_in(key, i), as the reference draws them."""
    size = x.numel()
    chunk = 1 << 26
    if size <= chunk:
        return R.uniform(key, x.shape).to(x.device)
    us = [R.uniform(R.fold_in(key, i), (chunk,))
          for i in range(-(-size // chunk))]
    return torch.cat(us)[:size].reshape(x.shape).to(x.device)


def l2_dithering(levels: int = 1) -> Compressor:
    """Random dithering / QSGD ℓ2 quantization (Alistarh et al. 2017):
    q(x)_i = ‖x‖₂·sign(x_i)·ξ_i, ξ_i a random rounding of |x_i|/‖x‖ onto
    {0, 1/s, ..., 1}. Unbiased, ω <= min(d/s², √d/s). The norm's squares
    are summed in XLA's lane order and rooted once (|x| for one
    coordinate), the rounding
    ``floor(scaled·s + u)`` is one fused multiply-add, and ``/ s`` a
    product with the rounded 1/s."""
    s = levels

    def compress(key, x):
        xf = X.ftz(x.reshape(-1).float())
        # one coordinate: XLA rewrites sqrt(x·x) into |x| (no overflow)
        norm = (xf.abs()[0] if xf.numel() == 1
                else X.sqrt(xla_sum_lanes(X.ftz(xf * xf))))
        zero = torch.zeros((), device=x.device)
        scaled = torch.where(norm > 0, xf.abs() / torch.clamp(norm, min=1e-30),
                             zero)
        u = _uniform_like(key, xf)
        level = torch.floor(fma_f32(X.ftz(scaled),
                                    torch.tensor(float(s), device=x.device),
                                    u))
        sign = torch.where(xf == 0, xf, torch.sign(xf))    # keeps -0.0
        out = X.ftz(X.ftz(norm * sign) * level) * _rcp(s).to(x.device)
        return X.ftz(out).reshape(x.shape).to(x.dtype)

    def omega(d):
        return min(d / s**2, (d ** 0.5) / s)

    # a coordinate is sent only when its level is positive: expected
    # density s(s + √d), each with a sign and a level, beside the norm
    def density(d):
        return min(s * (s + d ** 0.5), d)

    return Compressor(
        name=f"dither_s{s}", compress=compress, omega_fn=omega,
        bits_fn=lambda d: int(32 + density(d) * (2 + 32)),
        density_fn=density,
        # every block needs the whole vector's norm before a level
        # decodes: no one-pass blockwise wire (int8 is the blockwise kind)
        fallback_only=True)


def _exp2_int(e):
    """2^e of float32 integers e (and ±inf, NaN), exactly: the exponent
    bits of a normal float32 where -126 <= e <= 127."""
    finite = torch.isfinite(e)
    ei = torch.where(finite, e, torch.zeros_like(e)).clamp(-126, 127)
    p = ((ei.int() + 127) << 23).view(torch.float32)
    return torch.where(finite, p, torch.where(e > 0, e, e * 0.0))


def natural_compression() -> Compressor:
    """Natural compression (Horvath et al. 2019a): the magnitude rounded at
    random to one of its two neighbouring powers of two, unbiased, ω = 1/8;
    wire 9 bits a coordinate (sign and exponent). ``log2`` is XLA's
    ``log(x)`` times the rounded 1/log(2); subnormal magnitudes read as
    zero, as XLA's code flushes them."""
    rcp_ln2 = _rcp(X.log(torch.tensor(2.0)))

    def compress(key, x):
        xf = x.reshape(-1).float()
        mag = X.ftz(xf.abs())
        safe = torch.clamp(mag, min=1e-38)
        lo = torch.floor(X.ftz(X.log(safe) * rcp_ln2.to(x.device)))
        plo = _exp2_int(lo)
        phi = plo * 2.0
        p_hi = X.ftz(X.ftz(X.ftz(safe) - plo) / plo)     # P(round up)
        u = _uniform_like(key, xf)
        rounded = torch.where(u < p_hi, phi, plo)
        out = torch.where(mag > 0, torch.sign(xf) * rounded,
                          torch.zeros((), device=x.device))
        return out.reshape(x.shape).to(x.dtype)

    return Compressor(
        name="natural", compress=compress,
        omega_fn=lambda d: 1.0 / 8.0,
        bits_fn=lambda d: 9 * d,
        density_fn=lambda d: d,
        # 9-bit sign and exponent words have no packed dtype; a wire would
        # round-trip through int16 and save nothing over bf16
        fallback_only=True)


def _rcp(v) -> torch.Tensor:
    """float32 1/v, correctly rounded: XLA's product for a division by the
    constant v."""
    return torch.ones((), dtype=torch.float32) / v


def sign_scale(x):
    """(..., d) -> (..., 1) float32 mean(|x|) over the last axis: the sum
    in XLA's lane order times the rounded 1/d."""
    xf = x.float()
    return (xla_sum_lanes(xf.abs()) * _rcp(xf.shape[-1]).to(xf.device)
            )[..., None]


def sign_compressor() -> Compressor:
    """sign(x)·‖x‖₁/d, biased and contractive:
    ‖C(x) − x‖² ≤ (1 − 1/d)‖x‖². Wire: one bit a coordinate and a float32
    scale."""

    def compress(key, x):
        xf = x.reshape(-1).float()
        return (torch.sign(xf) * sign_scale(xf)).reshape(x.shape).to(x.dtype)

    return Compressor(
        name="sign", compress=compress,
        omega_fn=lambda d: float("nan"),     # not unbiased; no omega
        bits_fn=lambda d: d + 32,
        density_fn=lambda d: d,
        contractive_fn=lambda d: 1.0 - 1.0 / d, wire_format="sign")


INT8_BLOCK = 256       # coordinates sharing one float32 ℓ2 norm
INT8_LEVELS = 127      # the levels fit a signed int8


def block_norms(xb):
    """(..., blocks, B) float32 -> (..., blocks, 1) ℓ2 norms, as the
    reference's compiled code takes them: the rounded squares summed over
    the lanes in XLA's windows of 32 (``xla_sum_lanes``), then a correctly
    rounded square root (``torch.sqrt`` on the CPU is not: the root is
    taken in float64 and rounded once)."""
    total = xla_sum_lanes(xb * xb)
    return torch.sqrt(total.double()).float()[..., None]


def _int8_encode(key, x):
    """Blockwise ℓ2 dithering onto signed int8 levels, the encoder that
    ``compress`` and ``quantize.pack_int8`` share. key (..., 2), x (..., d)
    -> (levels (..., nb, B) int8, norms (..., nb) float32) over the
    zero-padded blocks; the dither is drawn over the padded (nb, B)
    shape."""
    xf = x.float()
    d = xf.shape[-1]
    xb = F.pad(xf, (0, (-d) % INT8_BLOCK))
    xb = xb.reshape(xb.shape[:-1] + (-1, INT8_BLOCK))
    norm = block_norms(xb)
    zero = torch.zeros((), device=x.device)
    scaled = torch.where(norm > 0, xb.abs() / torch.clamp(norm, min=1e-30),
                         zero)
    u = R.uniform(key, xb.shape[-2:]).to(x.device)
    level = torch.floor(fma_f32(scaled, torch.tensor(float(INT8_LEVELS),
                                                     device=x.device), u))
    return (torch.sign(xb) * level).to(torch.int8), norm[..., 0]


def int8_products(levels, norms):
    """(..., nb, B) int8 levels, (..., nb) norms -> (..., nb·B) float32
    norm·level, the decode before its division by 127."""
    out = norms[..., None] * levels.float()
    return out.reshape(out.shape[:-2] + (-1,))


def _int8_decode(levels, norms):
    """(..., nb, B) int8 + (..., nb) float32 -> (..., nb·B) float32
    dequantized values: norm·level times the rounded 1/127."""
    return int8_products(levels, norms) * _rcp(INT8_LEVELS).to(norms.device)


def int8_quantization() -> Compressor:
    """Blockwise ℓ2 dithering packed into an int8 wire (QSGD with s = 127
    levels per 256-coordinate block). Unbiased, ω ≤ min(B/s², √B/s);
    wire: 8 bits a coordinate and a float32 norm per block."""
    s, b = INT8_LEVELS, INT8_BLOCK

    def compress(key, x):
        levels, norms = _int8_encode(key, x.reshape(-1))
        out = _int8_decode(levels, norms)
        return out[:x.numel()].reshape(x.shape).to(x.dtype)

    return Compressor(
        name="int8", compress=compress,
        omega_fn=lambda d: min(b / s**2, (b ** 0.5) / s),
        bits_fn=lambda d: 8 * d + 32 * (-(-d // b)),
        density_fn=lambda d: d, wire_format="int8")


def bf16_cast() -> Compressor:
    """Round to bfloat16 (nearest even) and back: biased, contractive with
    δ = 2⁻¹⁶. Wire: 16 bits a coordinate."""
    return Compressor(
        name="bf16",
        compress=lambda key, x: x.to(torch.bfloat16).to(x.dtype),
        omega_fn=lambda d: float("nan"),     # deterministic rounding: biased
        bits_fn=lambda d: 16 * d,
        density_fn=lambda d: d,
        contractive_fn=lambda d: 2.0 ** -16, wire_format="bf16")


REGISTRY = {
    "identity": identity,
    "randk": rand_k,
    "topk": top_k,
    "dither": l2_dithering,
    "natural": natural_compression,
    "sign": sign_compressor,
    "int8": int8_quantization,
    "bf16": bf16_cast,
}

# the entries whose compressor has a ``contractive_fn``, as in the reference
CONTRACTIVE = ("bf16", "identity", "sign", "topk")


def get_compressor(name: str, **kw) -> Compressor:
    return REGISTRY[name](**kw)
