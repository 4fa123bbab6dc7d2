"""Compression operators (port of ``repro/core/compressors.py``).

Ported: ``identity``, ``rand_k`` (per-coordinate selection and the
contiguous-block selection above ``_MAX_UNITS`` units), ``top_k``,
``sign_compressor``, ``int8_quantization`` (blockwise ℓ2 dithering onto
int8 levels) and ``bf16_cast``. ``dither`` and ``natural`` are named so
specs validate, and raise ``NotImplementedError`` when built;
``CONTRACTIVE`` names the entries with a contraction bound, ported or not,
for ``byz_ef21``'s guard.

The float32 arithmetic is the reference's compiled code's: a sum over a
leaf or a block follows XLA's windows of 32 lanes
(``aggregators.xla_sum_lanes``), a division by a constant is a product
with its rounded reciprocal, and the dither's ``scaled·127 + u`` is one
fused multiply-add.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch import random as R
from repro_torch.core.aggregators import xla_sum_lanes
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


def _not_ported(name):
    def factory(**kw):
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet (ROADMAP queue 1, "
            "item 6b)")
    return factory


REGISTRY = {
    "identity": identity,
    "randk": rand_k,
    "topk": top_k,
    "dither": _not_ported("dither"),
    "natural": _not_ported("natural"),
    "sign": sign_compressor,
    "int8": int8_quantization,
    "bf16": bf16_cast,
}

# the entries whose compressor has a ``contractive_fn``, as in the reference
CONTRACTIVE = ("bf16", "identity", "sign", "topk")


def get_compressor(name: str, **kw) -> Compressor:
    return REGISTRY[name](**kw)
