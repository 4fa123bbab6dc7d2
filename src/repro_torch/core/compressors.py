"""Compression operators (port of ``repro/core/compressors.py``).

Ported: ``identity``, ``rand_k`` (per-coordinate selection and the
contiguous-block selection above ``_MAX_UNITS`` units) and ``top_k``. The
other registry entries are named so specs validate, and raise
``NotImplementedError`` when built; ``CONTRACTIVE`` names the entries with
a contraction bound, ported or not, for ``byz_ef21``'s guard.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import random as R


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


def _not_ported(name):
    def factory(**kw):
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet (ROADMAP queue 1, "
            "item 6)")
    return factory


REGISTRY = {
    "identity": identity,
    "randk": rand_k,
    "topk": top_k,
    **{nm: _not_ported(nm)
       for nm in ("dither", "natural", "sign", "int8", "bf16")},
}

# the entries whose compressor has a ``contractive_fn``, as in the reference
CONTRACTIVE = ("bf16", "identity", "sign", "topk")


def get_compressor(name: str, **kw) -> Compressor:
    return REGISTRY[name](**kw)
