"""Counter-based random numbers that reproduce ``jax.random`` bit for bit.

Every trajectory of the reference is a pure function of (spec, seed)
through ``jax.random``'s threefry2x32 generator: minibatch ``randint``,
the c_k ``bernoulli`` coin, RandK and bucketing ``permutation``s, and the
synthetic data's ``normal``s. A ``torch.Generator`` cannot produce those
streams, so this module re-implements them in plain PyTorch.

A key is an int64 tensor whose last axis holds the two uint32 words of a
JAX key (values masked to 32 bits; int64 because ``torch.uint32`` lacks
most ops). Keys may carry leading batch axes: ``split``, ``fold_in`` and
every sampler broadcast over them, so one call serves all workers.

Layout follows JAX 0.9.0 with ``jax_threefry_partitionable=True``:

* ``split(key, num)[i]`` and ``fold_in(key, i)`` are both
  threefry2x32(key, (0, i));
* ``random_bits(key, shape)`` hashes the flat iota split into (hi, lo)
  words and xors the two output words;
* ``uniform`` fills the mantissa of a float in [1, 2) and subtracts 1;
* ``randint`` combines two bit streams by modular arithmetic in uint32;
* ``permutation`` sorts by fresh 32-bit keys in
  ceil(3·ln(n)/ln(2³²−1)) stable rounds;
* ``choice`` with ``p`` searches u's place in cumsum(p), the cumsum in
  the blocked order of XLA's CPU code (``cumsum``);
* ``normal`` is sqrt(2)·erfinv(u) with XLA's single-precision erfinv
  polynomial (Giles) and XLA's own ``log-plus-one`` (``xla_math``), so
  the normals equal JAX's bit for bit; ``normal_bf16`` is JAX's
  bfloat16 draw (8 random bits a value, the float32 erfinv rounded, the
  product by bfloat16's sqrt(2) rounded again).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch import xla_math as X
from repro_torch.core.attacks import fma_f32

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u32(x):
    return x & _MASK


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1):
    """The 20-round threefry2x32 hash on broadcastable int64 tensors of
    uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = _u32(x0 + ks[0])
    x1 = _u32(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = _u32(x0 + x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _u32(x0 + ks[(i + 1) % 3])
        x1 = _u32(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _words(key):
    """Split a (..., 2) key into its two words, each (..., 1) so they
    broadcast against a trailing counter axis."""
    return key[..., 0:1], key[..., 1:2]


def _hash_counters(key, lo, shape):
    """threefry(key, (0, lo)) with lo a flat counter vector; output words
    shaped key.shape[:-1] + shape."""
    k1, k2 = _words(key)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    out_shape = tuple(key.shape[:-1]) + tuple(shape)
    return y0.reshape(out_shape), y1.reshape(out_shape)


def split(key, num: int = 2) -> torch.Tensor:
    """(..., 2) -> (..., num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = _hash_counters(key, lo, (num,))
    return torch.stack([y0, y1], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``. ``data`` is an int or an int tensor; a
    tensor of shape S gives keys of shape key.shape[:-1] + S + (2,)."""
    if isinstance(data, int):
        lo = torch.tensor([data & _MASK], dtype=torch.int64, device=key.device)
        y0, y1 = _hash_counters(key, lo, ())
    else:
        data = torch.as_tensor(data, device=key.device).to(torch.int64)
        y0, y1 = _hash_counters(key, _u32(data.reshape(-1)), data.shape)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, shape: Sequence[int] = ()) -> torch.Tensor:
    """32 random bits per element (as int64 in [0, 2³²)), shape
    key.shape[:-1] + shape."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise NotImplementedError("random_bits beyond 2**32 elements")
    lo = torch.arange(size, dtype=torch.int64, device=key.device)
    y0, y1 = _hash_counters(key, lo, shape)
    return y0 ^ y1


def _bits_to_unit(bits):
    """uint32 bits -> float32 in [0, 1) through the mantissa of [1, 2)."""
    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform on [minval, maxval)."""
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    floats = _bits_to_unit(random_bits(key, shape))
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key, p: float, shape: Sequence[int] = ()) -> torch.Tensor:
    """bool tensor, True with probability p (uniform < float32(p))."""
    pf = torch.tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < pf


def randint(key, shape: Sequence[int], minval: int, maxval: int):
    """int64 values in [minval, maxval) with JAX's 2×32-bit modular
    reduction (the values JAX returns as int32)."""
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = max(int(maxval) - int(minval), 1) & _MASK
    multiplier = _u32((2 ** 16 % span) ** 2) % span
    offset = _u32((higher % span) * multiplier)
    offset = _u32(offset + lower % span) % span
    return offset + int(minval)


# XLA on the CPU rewrites a cumulative sum into a blocked scan of this base
CUMSUM_BLOCK = 16


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 inclusive cumulative sum of a 1-D tensor as ``jnp.cumsum``
    runs on the CPU: cut into blocks of ``CUMSUM_BLOCK`` (the last
    zero-padded), a sequential sum inside each block, the block totals
    scanned the same way, recursively, and each block's exclusive prefix
    then added to its entries."""
    n = x.shape[0]
    b = CUMSUM_BLOCK
    if n <= b:
        out = [x[0]]
        for i in range(1, n):
            out.append(out[-1] + x[i])
        return torch.stack(out)
    nb = -(-n // b)
    blocks = torch.nn.functional.pad(x, (0, nb * b - n)).reshape(nb, b)
    cols = [blocks[:, 0]]
    for i in range(1, b):
        cols.append(cols[-1] + blocks[:, i])
    inner = torch.stack(cols, dim=1)
    totals = cumsum(inner[:, -1])
    rest = inner[1:] + totals[:-1, None]
    return torch.cat([inner[:1], rest]).reshape(-1)[:n]


def choice(key, n: int, shape: Sequence[int], p: torch.Tensor):
    """int64 draws from range(n) with replacement and probabilities ``p``
    (n,), shape key.shape[:-1] + shape, as ``jax.random.choice(key, n,
    shape, replace=True, p=p)``: r = cumsum(p)[-1]·(1 - u) for u uniform,
    placed in cumsum(p) by a left-sided search."""
    if p.shape != (n,):
        raise ValueError(f"p must have shape ({n},), got {tuple(p.shape)}")
    p_cuml = cumsum(p.float())
    r = p_cuml[-1] * (1.0 - uniform(key, shape).to(p.device))
    return torch.searchsorted(p_cuml, r.contiguous(), side="left")


def _shuffle_rounds(n: int) -> int:
    return int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))


def permutation(key, n: int) -> torch.Tensor:
    """A random permutation of arange(n), shape key.shape[:-1] + (n,):
    repeated stable sorts by fresh 32-bit keys, as ``jax.random``'s
    ``_shuffle`` (``lax.sort_key_val`` is stable)."""
    batch = tuple(key.shape[:-1])
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    x = x.expand(batch + (n,))
    for _ in range(_shuffle_rounds(n)):
        keys = split(key, 2)
        key, subkey = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(subkey, (n,)), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x.contiguous()


# Giles' single-precision erfinv, as XLA lowers ``lax.erf_inv`` for f32.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function by Giles' polynomial, as XLA's CPU
    backend compiles ``lax.erf_inv``: w = −log1p(−x²) in XLA's own
    ``log-plus-one`` (``xla_math``), a correctly rounded root, and each
    Horner step one fused multiply-add."""
    lw = X.log1p(x * -x)                                  # −w
    lt = lw > -5.0
    w = torch.where(lt, -2.5 - lw, X.sqrt(-lw) + -3.0)
    coef = [torch.tensor(c, dtype=torch.float32, device=x.device)
            for c in _ERFINV_LT5 + _ERFINV_GE5]
    p = fma_f32(w, torch.where(lt, coef[0], coef[9]),
                torch.where(lt, coef[1], coef[10]))
    for a, b in zip(coef[2:9], coef[11:]):
        p = fma_f32(w, p, torch.where(lt, a, b))
    inf = torch.tensor(float("inf"), device=x.device)
    return x * torch.where(x.abs() == 1.0, inf, p)


def normal(key, shape: Sequence[int] = (), scale: float = 1.0) -> torch.Tensor:
    """float32 normals of standard deviation ``scale``: sqrt(2)·erfinv(u),
    u uniform on (-1, 1), times ``scale`` as compiled code takes
    ``scale * normal(...)``: XLA folds the two constants into one float32
    product first."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return erfinv(u) * float(np.float32(np.float32(scale)
                                        * np.float32(np.sqrt(2))))


def normal_bf16(key, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.bfloat16)``: u from the low 8
    bits of each word (7 mantissa bits of [1, 2), minus 1), mapped onto
    [lo, 1) with lo = nextafter(-1, 0) = -(1 - 2⁻⁸) in bfloat16, whose
    span 1 - lo rounds to 2 there, so the map is exact; erfinv(u) in
    float32 rounded to bfloat16, then times bfloat16(sqrt(2)), rounded
    again."""
    bits = random_bits(key, shape) & 0xFF
    fb = ((bits >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)
    lo = -0.99609375
    u = torch.maximum(torch.tensor(lo, device=key.device),
                      (fb.float() - 1.0) * 2.0 + lo)
    sqrt2 = float(torch.tensor(math.sqrt(2)).to(torch.bfloat16))
    e = erfinv(u).to(torch.bfloat16)
    return (e.float() * sqrt2).to(torch.bfloat16)
