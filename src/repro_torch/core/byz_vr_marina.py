"""Byz-VR-MARINA (Algorithm 1): the engine-facing configuration (port of
``repro/core/byz_vr_marina.py``).

Per iteration: c_k ~ Be(p); x^{k+1} = x^k - γ g^k; good workers send
∇f_i(x^{k+1}) when c_k = 1 and g^k + Q(Δ̂_i(x^{k+1}, x^k)) otherwise;
byzantine workers send the attack; g^{k+1} = ARAgg(g_1, ..., g_n). The
round itself lives in ``engine`` and ``estimators.MarinaEstimator``.
Partial participation (``n_active``), the fault layer (``fault_plan``,
``fault_guard``) and the optimizer over g^k (``optimizer``, None for the
plain step x - γ g) are fields here.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from repro_torch.core.aggregators import Aggregator
from repro_torch.core.attacks import Attack, no_attack
from repro_torch.core.compressors import Compressor, identity
from repro_torch.core.engine import AGG_BACKENDS, PORTED_BACKENDS
from repro_torch.core.theory import delta_over_active_set


@dataclasses.dataclass(frozen=True)
class ByzVRMarinaConfig:
    n_workers: int
    n_byz: int = 0
    # partial participation: workers sampled each round (uniform without
    # replacement); None = all n_workers
    n_active: Optional[int] = None
    p: float = 0.1                       # full-gradient probability
    lr: float = 0.05
    aggregator: Aggregator = Aggregator("mean")
    compressor: Compressor = dataclasses.field(default_factory=identity)
    attack: Attack = dataclasses.field(default_factory=no_attack)
    agg_mode: str = "gspmd"              # gspmd | sparse_support | pallas
    fault_plan: Optional[object] = None  # faults.FaultPlan or None
    fault_guard: bool = False            # fail-closed non-finite masking
    optimizer: Optional[object] = None   # optim.SGD / optim.Adam, or None

    def __post_init__(self):
        if self.agg_mode not in AGG_BACKENDS:
            raise ValueError(f"agg_mode {self.agg_mode!r} not in "
                             f"{AGG_BACKENDS}")
        if self.agg_mode not in PORTED_BACKENDS:
            raise NotImplementedError(
                f"agg_mode {self.agg_mode!r} is not ported yet (ROADMAP "
                "queue 1, item 11)")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p={self.p} must be a probability in [0, 1]")
        if self.n_workers < 1:
            raise ValueError(f"n_workers={self.n_workers} must be >= 1")
        if (not 0 <= self.n_byz
                or delta_over_active_set(self.n_workers, self.n_byz) >= 0.5):
            raise ValueError(
                f"n_byz={self.n_byz} must satisfy 0 <= n_byz < n_workers/2 "
                f"(= {self.n_workers / 2:g}): no (delta,c)-robust aggregator "
                "exists for a byzantine majority (Def. 2.1)")
        if (self.n_active is not None
                and not 1 <= self.n_active <= self.n_workers):
            raise ValueError(f"n_active={self.n_active} must be in [1, "
                             f"n_workers={self.n_workers}]")
        n_act = self.active_count()
        s = max(self.aggregator.bucket_size, 1)
        delta = delta_over_active_set(n_act, self.n_byz, bucket_size=s)
        if self.aggregator.robust and s > 1 and delta >= 0.5:
            warnings.warn(
                f"after bucketing (s={s}) the byzantine fraction over the "
                f"active set is {delta:.2f} >= 1/2; Def. 2.1's robustness "
                "guarantee is void — reduce bucket_size or n_byz",
                stacklevel=2)
        if self.fault_plan is not None:
            f = self.fault_plan.worst_case_faulty(self.n_workers)
            if f and delta_over_active_set(n_act, self.n_byz + f) >= 0.5:
                warnings.warn(
                    f"fault plan can corrupt up to f={f} workers on top of "
                    f"n_byz={self.n_byz}: byz+faulty over the active set "
                    f"(n_active={n_act}) reaches >= 1/2, so the guarded δ "
                    "budget is exceeded in the worst round", stacklevel=2)

    def active_count(self) -> int:
        """Workers sampled per round; n_workers at full participation."""
        return self.n_workers if self.n_active is None else self.n_active

    def byz_mask(self, device=None) -> torch.Tensor:
        """(n,) bool: the first n_byz workers are byzantine."""
        return torch.arange(self.n_workers, device=device) < self.n_byz
