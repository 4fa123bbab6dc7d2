"""The paper's theory, executable (port of ``repro/core/theory.py``): the
δ bookkeeping that validates configurations, the step sizes and rates of
Thm. 2.1/2.2 and of the EF21 family, the communication count of a round,
and the constants of the logistic-regression task.

Everything but ``logreg_constants`` and ``importance_weights`` is float
arithmetic in Python, as in the reference. Those two reduce float32
features in the order of XLA's CPU reductions (``aggregators
.xla_sum_lanes``), so they equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def delta_over_active_set(n_active: int, n_byz_active: int, *,
                          bucket_size: int = 1) -> float:
    """Effective byzantine fraction δ over the cohort the aggregator sees;
    bucketing with size s multiplies it by s. An empty cohort counts as
    fully adversarial."""
    n_active = int(n_active)
    if n_active <= 0:
        return 1.0
    b = min(int(n_byz_active), n_active)
    return b * max(int(bucket_size), 1) / n_active


# (δ_max, c) certified by Theorem D.1 for each rule ∘ bucketing
AGG_CONSTANTS = {
    "krum": {"delta_max": 0.25, "c": 6.0},
    "rfa": {"delta_max": 0.5, "c": 6.0},
    "cm": {"delta_max": 0.5, "c": None},   # c = O(d): filled per problem
    "tm": {"delta_max": 0.5, "c": 6.0},
    "mean": {"delta_max": 0.0, "c": 0.0},
}


@dataclasses.dataclass(frozen=True)
class ProblemConstants:
    """Smoothness / heterogeneity constants of problem (1)."""
    L: float                  # global smoothness (As. 2.1)
    L_pm: float = 0.0         # global Hessian variance L± (As. 2.3)
    calL_pm: float = 0.0      # local Hessian variance 𝓛± (As. 2.4)
    zeta_sq: float = 0.0      # ζ² heterogeneity (As. 2.2)
    mu: float = 0.0           # PŁ constant (As. 2.5); 0 = non-convex
    m: int = 1                # local dataset size
    d: int = 1                # dimension


def marina_A(pc: ProblemConstants, *, p: float, b: int, G: int,
             delta: float, c: float, omega: float) -> float:
    """The A constant of Thm. 2.1/2.2 (B = 0):
    A = 6(1-p)/p [ (4cδ/p + 1/2G)(ω L² + (1+ω) 𝓛±²/b)
                  + (4cδ(1+ω)/p + ω/2G) L±² ]"""
    t1 = (4 * c * delta / p + 1 / (2 * G)) * (
        omega * pc.L ** 2 + (1 + omega) * pc.calL_pm ** 2 / b)
    t2 = (4 * c * delta * (1 + omega) / p + omega / (2 * G)) * pc.L_pm ** 2
    return 6 * (1 - p) / p * (t1 + t2)


def step_size(pc: ProblemConstants, *, p: float, b: int, G: int,
              delta: float, c: float, omega: float,
              pl: bool = False) -> float:
    """γ = 1/(L+√A) (Thm 2.1) or min{1/(L+√2A), p/4μ} (Thm 2.2)."""
    A = marina_A(pc, p=p, b=b, G=G, delta=delta, c=c, omega=omega)
    if pl:
        g1 = 1.0 / (pc.L + math.sqrt(2 * A))
        if pc.mu > 0:
            return min(g1, p / (4 * pc.mu))
        return g1
    return 1.0 / (pc.L + math.sqrt(A))


def recommended_p(*, b: int, m: int, omega: float) -> float:
    """p = min{b/m, 1/(1+ω)} (footnote 3)."""
    return min(b / m, 1.0 / (1.0 + omega))


def error_floor(*, delta: float, c: float, p: float, zeta_sq: float,
                mu: Optional[float] = None) -> float:
    """The heterogeneity floor: 24cδζ²/p on E‖∇f‖² (Thm 2.1), or
    24cδζ²/(μp) on f - f* under PŁ (Thm 2.2)."""
    if mu:
        return 24 * c * delta * zeta_sq / (mu * p)
    return 24 * c * delta * zeta_sq / p


def communication_rounds_nc(pc: ProblemConstants, *, eps_sq: float,
                            delta0: float, p: float, b: int, G: int,
                            delta: float, c: float, omega: float) -> float:
    """Non-convex rounds bound: 2Φ0 / (γ ε²) with Φ0 ≈ 2Δ0 (Eq. 30)."""
    gamma = step_size(pc, p=p, b=b, G=G, delta=delta, c=c, omega=omega)
    return 4 * delta0 / (gamma * eps_sq)


def communication_rounds_pl(pc: ProblemConstants, *, eps: float,
                            delta0: float, p: float, b: int, G: int,
                            delta: float, c: float, omega: float) -> float:
    """PŁ rounds bound: (1/γμ) log(2Δ0/ε) (Thm 2.2, ζ = 0)."""
    assert pc.mu > 0
    gamma = step_size(pc, p=p, b=b, G=G, delta=delta, c=c, omega=omega,
                      pl=True)
    return math.log(max(2 * delta0 / eps, 1.0 + 1e-9)) / (gamma * pc.mu)


def contractive_delta(compressor, d: int) -> Optional[float]:
    """δ_C with E‖C(x) - x‖² <= δ_C ‖x‖²: native for the biased
    compressors, ω/(1+ω) for an unbiased one after 1/(1+ω) scaling, None
    without a bound."""
    delta = compressor.contractive_delta(d)
    if delta is not None:
        return float(delta)
    omega = compressor.omega(d)
    if math.isnan(omega):
        return None
    return omega / (1.0 + omega)


def tree_contractive_delta(compressor, dims) -> Optional[float]:
    """δ_C of a compressor applied per leaf to a tree of leaf sizes
    ``dims``: the worst leaf's; None if any leaf has no bound."""
    deltas = [contractive_delta(compressor, int(d)) for d in dims]
    if any(dl is None for dl in deltas):
        return None
    return max(deltas)


def ef21_step_size(pc: ProblemConstants, *, delta_c: float,
                   byz_delta: float = 0.0, c: float = 6.0) -> float:
    """Byz-EF21 step size: γ = 1/(L + L̃ √δ_C/θ), θ = 1 - √δ_C, the
    error-feedback term scaled by (1 + √(4cδ)) for a δ-fraction of
    byzantines; δ_C = 0 gives 1/L."""
    if not 0.0 <= delta_c < 1.0:
        raise ValueError(f"delta_c={delta_c} must be in [0, 1) (contractive)")
    if delta_c == 0.0:
        return 1.0 / pc.L
    theta = 1.0 - math.sqrt(delta_c)
    l_tilde = max(pc.calL_pm, pc.L)
    ef_term = l_tilde * math.sqrt(delta_c) / theta
    ef_term *= 1.0 + math.sqrt(4.0 * c * byz_delta)
    return 1.0 / (pc.L + ef_term)


def ef21_rounds_nc(pc: ProblemConstants, *, eps_sq: float, delta0: float,
                   delta_c: float, byz_delta: float = 0.0,
                   c: float = 6.0) -> float:
    """Non-convex rounds bound of the EF21 family: 2Φ0/(γ ε²), Φ0 ≈ 2Δ0."""
    gamma = ef21_step_size(pc, delta_c=delta_c, byz_delta=byz_delta, c=c)
    return 4 * delta0 / (gamma * eps_sq)


# method -> wire family: "vr_switch" is MARINA's coin between full 32·d
# uploads and Q(·) rounds; "compressed" one Q(·) upload every round;
# "contractive_ef" one C(·) upload every round (error feedback, no full
# rounds); "dense" 32·d every round
BITS_FAMILY = {
    "marina": "vr_switch",
    "csgd": "compressed",
    "diana": "compressed",
    "cmfilter": "compressed",
    "byz_ef21": "contractive_ef",
    "sgd": "dense",
    "sgdm": "dense",
    "mvr": "dense",
    "svrg": "dense",
    "saga": "dense",
}


def comm_bits_per_round(method: str, compressor, d: int, *,
                        p: float = 1.0, dims=None,
                        participation: float = 1.0) -> float:
    """Expected uploaded bits per configured worker per round.

    ``dims`` (per-leaf flat sizes) switches to the per-leaf accounting,
    Σ_l bits_Q(d_l), what ``wire.pack_candidates`` puts on the wire;
    without it one vector of d coordinates. ``participation``, the sampled
    fraction of the workers, scales the expectation: a worker left out
    uploads nothing that round (the runner bills n_active / n_workers of
    each round likewise)."""
    if method not in BITS_FAMILY:
        raise KeyError(
            f"unknown method {method!r}; known: {sorted(BITS_FAMILY)}")
    family = BITS_FAMILY[method]
    if dims is not None:
        d = int(sum(int(x) for x in dims))
    dense = 32.0 * d
    if family == "dense":
        return participation * dense
    bits_q = (float(compressor.tree_bits(dims)) if dims is not None
              else float(compressor.bits_per_vector(d)))
    if family == "vr_switch":
        return participation * (p * dense + (1.0 - p) * bits_q)
    return participation * bits_q      # compressed | contractive_ef


def _row_sq(features):
    """(m,) float32 ‖a_j‖²: the squares summed over each row's lanes in
    XLA's order."""
    from repro_torch.xla_math import xla_sum_lanes
    x = torch.as_tensor(features).float()
    return xla_sum_lanes(x * x)


def _mean(v):
    """float32 mean of a 1-D tensor as ``jnp.mean`` compiles it: the sum in
    XLA's lane order times the rounded 1/m."""
    from repro_torch.xla_math import xla_sum_lanes
    rcp = torch.ones((), dtype=torch.float32) / v.shape[0]
    return xla_sum_lanes(v) * rcp.to(v.device)


def logreg_constants(features, lam: float, *, n_workers: int,
                     homogeneous: bool = True) -> ProblemConstants:
    """ℓ2-regularized logistic regression: per-sample smoothness
    L_j = ‖a_j‖²/4 + 2λ; f is 2λ-strongly convex, so PŁ with μ = 2λ."""
    row_sq = _row_sq(features)
    L_i = float(row_sq.max()) / 4 + 2 * lam
    L_avg = float(_mean(row_sq)) / 4 + 2 * lam
    return ProblemConstants(
        L=L_avg, L_pm=0.0 if homogeneous else L_avg,
        calL_pm=L_i,                     # worst-case bound (Ex. E.1)
        mu=2 * lam, m=row_sq.shape[0], d=features.shape[1])


def importance_weights(features, lam: float):
    """Example E.2 importance sampling, P(j) ∝ L_j = ‖a_j‖²/4 + 2λ, in
    float32. Returns (probs (m,), L̄)."""
    from repro_torch.xla_math import xla_sum_lanes
    L_j = _row_sq(features) / 4 + 2 * lam
    return L_j / xla_sum_lanes(L_j), float(_mean(L_j))
