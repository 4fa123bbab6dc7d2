"""``RunSpec`` — one frozen, serializable description of an experiment
(port of ``repro/api/spec.py``).

The fields, defaults and JSON form are the reference's, so one
``RunSpec.to_dict()`` drives both packages. Names are validated through
``api.registry``, as in the reference; components this slice has not
ported are accepted here and raise ``NotImplementedError`` from
``build_config`` (``arch`` is not validated: the port has no model
configs yet). ``ServeSpec`` is not ported yet (ROADMAP queue 1,
item 10).
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Optional

from repro_torch.api import registry
from repro_torch.core import compressors
from repro_torch.core.engine import AGG_BACKENDS
from repro_torch.core.theory import delta_over_active_set
from repro_torch.faults.plan import as_plan

SCHEMA_VERSION = 1

_KWARGS_FIELDS = ("method_kwargs", "attack_kwargs", "aggregator_kwargs",
                  "compressor_kwargs", "optimizer_kwargs", "data_kwargs",
                  "faults")
_CHECKED = ("task", "method", "attack", "aggregator", "compressor",
            "optimizer")


def resolve_agg_mode(mode: str) -> str:
    """CLI convenience: "auto" -> the kernel path (``"pallas"``) where a
    CUDA device is present, the plain path (``"gspmd"``) elsewhere. Specs
    always store the resolved mode."""
    if mode != "auto":
        return mode
    import torch
    return "pallas" if torch.cuda.is_available() else "gspmd"


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Declarative experiment description; every field is a JSON scalar or
    a JSON-scalar dict, validated eagerly in ``__post_init__``."""

    task: str = "logreg"
    arch: Optional[str] = None
    method: str = "marina"
    n_workers: int = 5
    n_byz: int = 1
    attack: str = "ALIE"
    aggregator: str = "cm"
    bucket_size: int = 2
    agg_mode: str = "gspmd"
    compressor: str = "identity"
    p: float = 0.1
    lr: float = 0.5
    optimizer: str = "none"
    participation: float = 1.0
    steps: int = 100
    seed: int = 0
    trace: bool = False
    faults: dict = dataclasses.field(default_factory=dict)
    fault_guard: bool = False
    method_kwargs: dict = dataclasses.field(default_factory=dict)
    attack_kwargs: dict = dataclasses.field(default_factory=dict)
    aggregator_kwargs: dict = dataclasses.field(default_factory=dict)
    compressor_kwargs: dict = dataclasses.field(default_factory=dict)
    optimizer_kwargs: dict = dataclasses.field(default_factory=dict)
    data_kwargs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for kind in _CHECKED:
            registry.check(kind, getattr(self, kind))
        if self.agg_mode not in AGG_BACKENDS:
            hint = (" — pass 'auto' through api.spec.resolve_agg_mode() "
                    "first" if self.agg_mode == "auto" else "")
            raise ValueError(
                f"agg_mode {self.agg_mode!r} not in {AGG_BACKENDS}{hint}")
        if not 0.0 < self.p <= 1.0:
            raise ValueError(
                f"p={self.p} must be in (0, 1] (full-gradient probability)")
        if self.n_workers < 1:
            raise ValueError(f"n_workers={self.n_workers} must be >= 1")
        if self.n_byz < 0:
            raise ValueError(f"n_byz={self.n_byz} must be >= 0")
        if delta_over_active_set(self.n_workers, self.n_byz) >= 0.5:
            raise ValueError(
                f"n_byz={self.n_byz} of n_workers={self.n_workers} gives "
                f"delta={self.n_byz / self.n_workers:.2f} >= 1/2 — no "
                "(delta,c)-robust aggregator exists; reduce n_byz or add "
                "workers")
        n_active = self.resolved_participation()
        if n_active < self.n_workers:
            if self.agg_mode not in ("gspmd", "pallas"):
                raise ValueError(
                    f"participation={self.participation} is not supported "
                    f"under agg_mode={self.agg_mode!r}: per-round client "
                    "sampling needs the masked aggregation prologue, which "
                    "lives in the gspmd and pallas backends")
            # worst case over the sampled cohort: every byzantine may land
            # in one round's sample
            worst = delta_over_active_set(n_active, self.n_byz)
            if self.aggregator != "mean" and worst >= 0.5:
                warnings.warn(
                    f"worst-case sampled byzantine fraction is "
                    f"{worst:.2f} >= 1/2 (n_byz={self.n_byz} vs n_active="
                    f"{n_active}): a round whose sample is majority-"
                    "byzantine has no (delta,c) guarantee; raise "
                    "participation or reduce n_byz", stacklevel=2)
        s = max(self.bucket_size, 1)
        delta = delta_over_active_set(n_active, self.n_byz, bucket_size=s)
        if self.aggregator != "mean" and s > 1 and delta >= 0.5:
            warnings.warn(
                f"after bucketing (s={s}) the byzantine fraction over the "
                f"active set is {delta:.2f} >= 1/2: Def. 2.1's guarantee is "
                "void; reduce bucket_size or n_byz", stacklevel=2)
        if self.bucket_size < 0:
            raise ValueError(f"bucket_size={self.bucket_size} must be >= 0")
        if self.steps < 0:
            raise ValueError(f"steps={self.steps} must be >= 0")
        if self.task == "lm" and self.arch is None:
            raise ValueError("task='lm' needs arch=<name>")
        if self.method == "saga" and self.task == "lm":
            raise ValueError(
                "method='saga' needs a FIXED anchor set (its per-sample "
                "gradient table is indexed by position into the anchor), "
                "but the lm task's TokenStream resamples the anchor every "
                "round — the 'correction' term would be noise, not SAGA. "
                "Use task='logreg', or a VR method without per-sample "
                "state (marina / byz_ef21 / mvr)")
        if (self.method == "byz_ef21"
                and self.compressor not in compressors.CONTRACTIVE):
            raise ValueError(
                "method='byz_ef21' needs a contractive compressor "
                "(topk / sign / identity): EF21's error-feedback "
                "recursion contracts only under "
                "E||C(x)-x||^2 <= delta_C ||x||^2, and unbiasedness "
                "scaling (randk's d/K) breaks it; got "
                f"compressor={self.compressor!r}")
        if self.trace and self.agg_mode in ("all_to_all", "sparse_support"):
            raise ValueError(
                f"trace=True is not supported under agg_mode="
                f"{self.agg_mode!r}: the sharded wire modes never hold the "
                "stacked candidates in one place, so per-worker influence / "
                "distance diagnostics have nothing to read. Use 'gspmd' or "
                "'pallas'")
        if self.faults or self.fault_guard:
            plan = as_plan(self.faults)    # raises on unknown kinds/keys
            if self.fault_guard and self.agg_mode not in ("gspmd", "pallas"):
                raise ValueError(
                    f"fault_guard=True is not supported under agg_mode="
                    f"{self.agg_mode!r}: the fail-closed masking lives in "
                    "the aggregation prologue of the gspmd and pallas "
                    "backends")
            if plan is not None:
                f = plan.worst_case_faulty(self.n_workers)
                if f and delta_over_active_set(
                        n_active, self.n_byz + f) >= 0.5:
                    warnings.warn(
                        f"fault plan can hit {f} worker(s) on top of "
                        f"n_byz={self.n_byz}: worst-case byz+faulty "
                        f"fraction over the active set (n_active="
                        f"{n_active}) is >= 1/2, outside the guard's delta "
                        "budget — the drop-faulty-workers equivalence is "
                        "not guaranteed this round", stacklevel=2)
        if self.method == "marina" and self.agg_mode == "sparse_support":
            if (self.compressor != "randk"
                    or not self.compressor_kwargs.get("common_randomness")):
                raise ValueError(
                    "agg_mode='sparse_support' needs compressor='randk' with "
                    "compressor_kwargs={'ratio': ..., "
                    "'common_randomness': True} so all workers share the "
                    f"per-step support; got compressor={self.compressor!r} "
                    f"kwargs={self.compressor_kwargs}")
        for fname in _KWARGS_FIELDS:
            val = getattr(self, fname)
            if not isinstance(val, dict):
                raise TypeError(f"{fname} must be a dict, got {type(val)}")
            try:
                ok = json.loads(json.dumps(val)) == val
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"{fname}={val!r} must round-trip through JSON exactly "
                    "(plain str/int/float/bool/None scalars, lists, dicts)")

    def resolved_participation(self) -> int:
        """Workers sampled each round: a fraction in (0, 1] rounded to a
        count (never below 1), or a count in [1, n_workers]."""
        part = self.participation
        if isinstance(part, bool) or not isinstance(part, (int, float)):
            raise ValueError(
                f"participation={part!r} must be a fraction in (0, 1] or "
                "an integer count in [1, n_workers]")
        if isinstance(part, int):
            if not 1 <= part <= self.n_workers:
                raise ValueError(
                    f"participation={part} (count) must be in [1, "
                    f"n_workers={self.n_workers}]")
            return part
        if not 0.0 < part <= 1.0:
            raise ValueError(
                f"participation={part} (fraction) must be in (0, 1]")
        return max(1, min(self.n_workers, round(part * self.n_workers)))

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        """Plain-JSON dict in field order; exact ``from_dict`` inverse."""
        out = {"schema_version": SCHEMA_VERSION}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = dict(v) if isinstance(v, dict) else v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "RunSpec":
        d = dict(d)
        version = d.pop("schema_version", SCHEMA_VERSION)
        if version != SCHEMA_VERSION:
            raise ValueError(
                f"spec schema_version {version} != {SCHEMA_VERSION}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown RunSpec field(s): {unknown}")
        return cls(**d)

    def to_json(self, **dumps_kw) -> str:
        dumps_kw.setdefault("indent", 1)
        return json.dumps(self.to_dict(), **dumps_kw)

    @classmethod
    def from_json(cls, s: str) -> "RunSpec":
        return cls.from_dict(json.loads(s))

    def replace(self, **updates) -> "RunSpec":
        """``dataclasses.replace`` plus dotted-key merges into the kwargs
        dicts: ``spec.replace(**{"compressor_kwargs.ratio": 0.1})``."""
        merged: dict = {}
        for key, val in updates.items():
            if "." in key:
                parent, sub = key.split(".", 1)
                if parent not in _KWARGS_FIELDS:
                    raise ValueError(
                        f"dotted override {key!r}: {parent!r} is not one of "
                        f"{_KWARGS_FIELDS}")
                base = merged.get(parent, dict(getattr(self, parent)))
                base[sub] = val
                merged[parent] = base
            else:
                merged[key] = val
        return dataclasses.replace(self, **merged)

    # -- builders -----------------------------------------------------------
    def build_config(self):
        """Resolve the named components into a ``ByzVRMarinaConfig``; raises
        ``NotImplementedError`` for what this slice has not ported."""
        from repro_torch.core.byz_vr_marina import ByzVRMarinaConfig
        unported = [
            (self.task != "logreg", "task='lm' (ROADMAP queue 1, item 12)"),
            (self.optimizer != "none",
             "optimizers (ROADMAP queue 1, item 12)"),
        ]
        for hit, what in unported:
            if hit:
                raise NotImplementedError(f"{what} is not ported yet")
        agg_kw = {"n_byz": self.n_byz, **self.aggregator_kwargs}
        if self.aggregator == "mean":
            agg_kw.pop("n_byz")
        n_active = self.resolved_participation()
        return ByzVRMarinaConfig(
            n_workers=self.n_workers, n_byz=self.n_byz,
            n_active=None if n_active == self.n_workers else n_active,
            fault_plan=as_plan(self.faults), fault_guard=self.fault_guard,
            p=self.p, lr=self.lr,
            aggregator=registry.resolve("aggregator", self.aggregator,
                                        bucket_size=self.bucket_size,
                                        **agg_kw),
            compressor=registry.resolve("compressor", self.compressor,
                                        **self.compressor_kwargs),
            attack=registry.resolve("attack", self.attack,
                                    **self.attack_kwargs),
            agg_mode=self.agg_mode)

    def build(self, device=None):
        """-> ``runner.Experiment`` (method, data, loss, corrupt_fn)."""
        from repro_torch.api import runner
        return runner.build(self, device)

    def run(self, device=None, **run_kw):
        """Build and run through the shared loop (``api/runner.py``)."""
        from repro_torch.api import runner
        return runner.run(self, device, **run_kw)
