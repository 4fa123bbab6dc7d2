"""Byzantine attacks (port of ``repro/core/attacks.py``).

``attack(key, honest, good_mean, good_std) -> sent``. BF / ALIE / IPM also
carry the kernel-fusable ``CoordAttack`` form that the robust-aggregation
kernel applies inside its load. RN, scaled standard normals from
``repro_torch.random`` (the reference's ``jax.random.normal`` stream),
has no such form: it is applied to the materialized candidates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


def fma_f32(a, b, c):
    """a·b + c of float32 tensors, rounded once to float32: the fused
    multiply-add of the reference's compiled code and of the kernels. The
    product of two float32 values is exact in float64; the float64 sum is
    rounded to odd (where it is inexact and even, it steps one ulp towards
    the exact value, whose error TwoSum gives), and a value rounded to odd
    with 29 spare bits rounds to float32 as the exact value would."""
    p = a.double() * b.double()
    cd = c.double()
    r = p + cd
    bv = r - p
    err = (p - (r - bv)) + (cd - bv)
    even = (r.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, float("inf"), float("-inf")).to(r.dtype)
    return torch.where((err != 0) & even, torch.nextafter(r, away),
                       r).float()


def alie_value(m, z: float, s):
    """float32 m - z·s rounded once, as the reference's compiled code
    computes it (a fused multiply-add)."""
    zf = float(np.float32(-z))
    return fma_f32(s.new_full((), zf), s, m)


@dataclasses.dataclass(frozen=True)
class CoordAttack:
    """Elementwise attack on a (n, t) block given mean/std rows (1, t)."""
    kind: str                       # BF | ALIE | IPM
    param: float = 0.0              # ALIE z / IPM eps

    def __call__(self, x, m, s):
        if self.kind == "BF":
            return -x
        if self.kind == "ALIE":
            return alie_value(m, self.param, s).expand(x.shape)
        if self.kind == "IPM":
            return (-self.param * m).expand(x.shape)
        raise ValueError(self.kind)


@dataclasses.dataclass(frozen=True)
class Attack:
    name: str
    apply: Callable                 # (key, honest, good_mean, good_std) -> v
    flips_labels: bool = False
    coord_apply: Optional[CoordAttack] = None
    needs_mean: bool = False
    needs_std: bool = False


def no_attack() -> Attack:
    return Attack("NA", lambda key, h, m, s: h)


def label_flip() -> Attack:
    return Attack("LF", lambda key, h, m, s: h, flips_labels=True)


def bit_flip() -> Attack:
    return Attack("BF", lambda key, h, m, s: -h,
                  coord_apply=CoordAttack("BF"))


def alie(z: float = 1.06) -> Attack:
    """mu_G - z * sigma_G."""
    def apply(key, h, m, s):
        return alie_value(m, z, s).to(h.dtype).expand(h.shape)

    return Attack("ALIE", apply, coord_apply=CoordAttack("ALIE", z),
                  needs_mean=True, needs_std=True)


def ipm(eps: float = 0.1) -> Attack:
    """-(eps) * mean of good updates."""
    def apply(key, h, m, s):
        return (-eps * m).to(h.dtype).expand(h.shape)

    return Attack("IPM", apply, coord_apply=CoordAttack("IPM", eps),
                  needs_mean=True)


def random_noise(scale: float = 10.0) -> Attack:
    """scale · N(0, 1) in every coordinate, one key for every leaf."""
    def apply(key, h, m, s):
        if h.dtype != torch.float32:
            raise NotImplementedError(
                f"attack 'RN' on {h.dtype} candidates is not ported yet "
                "(ROADMAP queue 1, item 12)")
        from repro_torch import random as R
        return R.normal(key, h.shape, scale)

    return Attack("RN", apply)


REGISTRY = {
    "NA": no_attack,
    "LF": label_flip,
    "BF": bit_flip,
    "ALIE": alie,
    "IPM": ipm,
    "RN": random_noise,
}


def get_attack(name: str, **kw) -> Attack:
    return REGISTRY[name](**kw)


def attack_code(attack: Optional[CoordAttack]) -> int:
    """The kernel's attack selector: 0 none, 1 BF, 2 ALIE, 3 IPM."""
    if attack is None:
        return 0
    return {"BF": 1, "ALIE": 2, "IPM": 3}[attack.kind]
