"""Byzantine attacks (port of ``repro/core/attacks.py``).

``attack(key, honest, good_mean, good_std) -> sent``. BF / ALIE / IPM also
carry the kernel-fusable ``CoordAttack`` form that the robust-aggregation
kernel applies inside its load. RN (it needs ``jax.random``'s normal
stream on the materialized tensor) is not ported in this slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


def alie_value(m, z: float, s):
    """float32 m - z·s rounded once, as the reference's compiled code
    computes it (a fused multiply-add): the float32 product is exact in
    float64, so one float64 subtraction and one rounding to float32 give
    the fused result (up to a double rounding, which needs the exact value
    within 2^-53 relative of a float32 midpoint)."""
    zf = float(np.float32(z))
    return (m.double() - zf * s.double()).float()


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


def random_noise(**kw) -> Attack:
    raise NotImplementedError(
        "attack 'RN' is not ported yet (ROADMAP queue 1, item 3)")


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
