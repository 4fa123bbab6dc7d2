"""``RunSpec`` — one frozen, serializable description of an experiment —
and ``ServeSpec``, its streaming twin (port of ``repro/api/spec.py``).

The fields, defaults and JSON form are the reference's, so one
``to_dict()`` drives both packages. Names are validated through
``api.registry``, as in the reference; an ``arch`` whose blocks are not
ported yet raises ``NotImplementedError`` there, naming its ROADMAP
item.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Optional

from repro_torch.api import registry
from repro_torch.core import compressors
from repro_torch.core.engine import AGG_BACKENDS
from repro_torch.core.estimators import streamable
from repro_torch.core.theory import delta_over_active_set
from repro_torch.faults.plan import as_plan

SCHEMA_VERSION = 1

_KWARGS_FIELDS = ("method_kwargs", "attack_kwargs", "aggregator_kwargs",
                  "compressor_kwargs", "optimizer_kwargs", "data_kwargs",
                  "faults")
_CHECKED = ("task", "method", "attack", "aggregator", "compressor",
            "optimizer")


def _check_json_dicts(spec, fields) -> None:
    """Each of ``fields`` is a dict that round-trips through JSON."""
    for fname in fields:
        val = getattr(spec, fname)
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


def _replace(spec, fields, updates: dict):
    """``dataclasses.replace`` with dotted keys merged into the dicts of
    ``fields``."""
    merged: dict = {}
    for key, val in updates.items():
        if "." in key:
            parent, sub = key.split(".", 1)
            if parent not in fields:
                raise ValueError(
                    f"dotted override {key!r}: {parent!r} is not one of "
                    f"{fields}")
            base = merged.get(parent, dict(getattr(spec, parent)))
            base[sub] = val
            merged[parent] = base
        else:
            merged[key] = val
    return dataclasses.replace(spec, **merged)


class _JSONSpec:
    """The specs' JSON form: ``schema_version``, then ``kind`` where the
    class has one (``"serve"``), then every field in order."""
    _kind: Optional[str] = None

    def to_dict(self) -> dict:
        """Plain-JSON dict in field order; exact ``from_dict`` inverse."""
        out = {"schema_version": SCHEMA_VERSION}
        if self._kind is not None:
            out["kind"] = self._kind
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = dict(v) if isinstance(v, dict) else v
        return out

    @classmethod
    def from_dict(cls, d: dict):
        d = dict(d)
        version = d.pop("schema_version", SCHEMA_VERSION)
        if version != SCHEMA_VERSION:
            raise ValueError(
                f"spec schema_version {version} != {SCHEMA_VERSION}")
        if cls._kind is not None:
            kind = d.pop("kind", cls._kind)
            if kind != cls._kind:
                raise ValueError(
                    f"not a {cls.__name__} payload: kind={kind!r}")
        known = sorted(f.name for f in dataclasses.fields(cls))
        unknown = sorted(set(d) - set(known))
        if unknown:
            import difflib
            hints = []
            for k in unknown:
                close = difflib.get_close_matches(k, known, n=1)
                hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                         if close else ""))
            raise ValueError(f"unknown {cls.__name__} field(s): "
                             + ", ".join(hints))
        return cls(**d)

    def to_json(self, **dumps_kw) -> str:
        dumps_kw.setdefault("indent", 1)
        return json.dumps(self.to_dict(), **dumps_kw)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


def resolve_agg_mode(mode: str) -> str:
    """CLI convenience: "auto" -> the kernel path (``"pallas"``) where a
    CUDA device is present, the plain path (``"gspmd"``) elsewhere. Specs
    always store the resolved mode."""
    if mode != "auto":
        return mode
    import torch
    return "pallas" if torch.cuda.is_available() else "gspmd"


@dataclasses.dataclass(frozen=True)
class RunSpec(_JSONSpec):
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
        if self.arch is not None:
            registry.check("arch", self.arch)
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
            raise ValueError(
                "task='lm' needs arch=<name>; registered: "
                + ", ".join(registry.components("arch")))
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
        _check_json_dicts(self, _KWARGS_FIELDS)

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

    # -- serialization (``_JSONSpec``) ---------------------------------------
    def replace(self, **updates) -> "RunSpec":
        """``dataclasses.replace`` plus dotted-key merges into the kwargs
        dicts: ``spec.replace(**{"compressor_kwargs.ratio": 0.1})``."""
        return _replace(self, _KWARGS_FIELDS, updates)

    # -- builders -----------------------------------------------------------
    def build_config(self):
        """Resolve the named components into a ``ByzVRMarinaConfig``."""
        from repro_torch.core.byz_vr_marina import ByzVRMarinaConfig
        agg_kw = {"n_byz": self.n_byz, **self.aggregator_kwargs}
        if self.aggregator == "mean":
            agg_kw.pop("n_byz")
        opt_kw = {"lr": self.lr, **self.optimizer_kwargs}
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
            agg_mode=self.agg_mode,
            optimizer=registry.resolve("optimizer", self.optimizer,
                                       **opt_kw))

    def build(self, device=None):
        """-> ``runner.Experiment`` (method, data, loss, corrupt_fn)."""
        from repro_torch.api import runner
        return runner.build(self, device)

    def run(self, device=None, **run_kw):
        """Build and run through the shared loop (``api/runner.py``)."""
        from repro_torch.api import runner
        return runner.run(self, device, **run_kw)


# ---------------------------------------------------------------------------
# streaming-aggregation service spec (repro_torch.serve)
# ---------------------------------------------------------------------------

SERVE_AGG_MODES = ("gspmd", "pallas")
ARRIVAL_MODES = ("const", "exp", "lognormal", "trace")
STALENESS_MODES = ("none", "fedbuff")
_SERVE_KWARGS_FIELDS = ("arrival_kwargs", "method_kwargs", "attack_kwargs",
                        "aggregator_kwargs", "compressor_kwargs",
                        "data_kwargs")


@dataclasses.dataclass(frozen=True)
class ServeSpec(_JSONSpec):
    """Declarative description of a buffered-asynchronous aggregation
    service run (``repro_torch.serve.service``), the streaming counterpart
    of ``RunSpec``: n_clients dispatch updates continuously under a seeded
    arrival process, the service fires the robust aggregator whenever the
    buffer holds ``buffer_size`` deduplicated updates, and stale
    candidates are FedBuff-weighted (``1/sqrt(1+tau)``) inside the
    kernels' bucket operator. Every field is a JSON scalar or a scalar
    dict, validated eagerly, and the spec round-trips exactly through
    ``to_dict`` / ``from_dict``, in this package and the reference.
    """

    # task / model
    task: str = "logreg"                 # registry "task": logreg | lm
    arch: Optional[str] = None           # registry "arch" (lm task)
    # gradient estimator — must be streamable (pure per-client candidates)
    method: str = "sgd"
    # client population & byzantine setup (fraction is over the BUFFER)
    n_clients: int = 32
    n_byz: int = 4
    attack: str = "ALIE"                 # registry "attack"
    # robust aggregation
    aggregator: str = "cm"               # registry "aggregator"
    bucket_size: int = 0                 # Alg. 2 bucketing (0/1 = off)
    agg_mode: str = "gspmd"              # SERVE_AGG_MODES only
    # compression (applied per dispatched update, like csgd's wire)
    compressor: str = "identity"         # registry "compressor"
    # optimization
    lr: float = 0.5
    # buffered-async protocol
    buffer_size: int = 8                 # K: fire threshold
    rounds: int = 20                     # fired aggregation rounds
    staleness: str = "fedbuff"           # STALENESS_MODES
    # arrival process (repro_torch.serve.arrivals)
    arrival: str = "exp"                 # ARRIVAL_MODES
    seed: int = 0
    # observability: fired rounds run the traced aggregation twin and the
    # result carries per-fire RoundTraces
    trace: bool = False
    # per-component kwargs (JSON scalars only)
    arrival_kwargs: dict = dataclasses.field(default_factory=dict)
    method_kwargs: dict = dataclasses.field(default_factory=dict)
    attack_kwargs: dict = dataclasses.field(default_factory=dict)
    aggregator_kwargs: dict = dataclasses.field(default_factory=dict)
    compressor_kwargs: dict = dataclasses.field(default_factory=dict)
    data_kwargs: dict = dataclasses.field(default_factory=dict)

    # -- validation ---------------------------------------------------------
    def __post_init__(self):
        for kind in ("task", "method", "attack", "aggregator", "compressor"):
            registry.check(kind, getattr(self, kind))
        if self.arch is not None:
            registry.check("arch", self.arch)
        if not streamable(self.method):
            raise ValueError(
                f"method {self.method!r} is not streamable: the buffered-"
                "async service needs candidates that are a pure function of "
                "(params, batch, key) per client, but this estimator carries "
                "round-coupled shared state (e.g. MARINA's c_k coin or "
                "anchor broadcasts). Streamable methods: "
                + ", ".join(n for n in registry.components("method")
                            if streamable(n)))
        if self.agg_mode not in SERVE_AGG_MODES:
            raise ValueError(
                f"agg_mode {self.agg_mode!r} not in {SERVE_AGG_MODES} — the "
                "service aggregates a device-resident buffer, so the "
                "sharded wire modes (all_to_all / sparse_support) do not "
                "apply")
        if self.arrival not in ARRIVAL_MODES:
            raise ValueError(
                f"arrival {self.arrival!r} not in {ARRIVAL_MODES}")
        if self.staleness not in STALENESS_MODES:
            raise ValueError(
                f"staleness {self.staleness!r} not in {STALENESS_MODES}")
        if self.n_clients < 1:
            raise ValueError(f"n_clients={self.n_clients} must be >= 1")
        if self.n_byz < 0:
            raise ValueError(f"n_byz={self.n_byz} must be >= 0")
        if delta_over_active_set(self.n_clients, self.n_byz) >= 0.5:
            raise ValueError(
                f"n_byz={self.n_byz} of n_clients={self.n_clients} gives "
                f"delta={self.n_byz / self.n_clients:.2f} >= 1/2 over the "
                "client population — no (delta,c)-robust aggregator exists")
        if not 1 <= self.buffer_size <= self.n_clients:
            raise ValueError(
                f"buffer_size={self.buffer_size} must be in [1, n_clients="
                f"{self.n_clients}] — sequence-number dedup admits at most "
                "one in-flight update per client into a buffer")
        if self.rounds < 0:
            raise ValueError(f"rounds={self.rounds} must be >= 0")
        if self.bucket_size < 0:
            raise ValueError(f"bucket_size={self.bucket_size} must be >= 0")
        if self.task == "lm" and self.arch is None:
            raise ValueError(
                "task='lm' needs arch=<name>; registered: "
                + ", ".join(registry.components("arch")))
        # the byzantine fraction the aggregator sees is over the BUFFER
        # (the service's active set): in the worst case every byzantine
        # client lands in one buffer of size K
        worst = delta_over_active_set(self.buffer_size, self.n_byz)
        if self.aggregator != "mean" and worst >= 0.5:
            warnings.warn(
                f"worst-case buffered byzantine fraction is "
                f"{worst:.2f} >= 1/2 (n_byz={self.n_byz} "
                f"vs buffer_size={self.buffer_size}): no (delta,c)-robust "
                "aggregator can cover a buffer where byzantines are the "
                "majority; raise buffer_size or reduce n_byz",
                stacklevel=2)
        if self.arrival == "trace" and "path" not in self.arrival_kwargs \
                and "events" not in self.arrival_kwargs:
            raise ValueError(
                "arrival='trace' needs arrival_kwargs={'path': <trace.json>}"
                " (or an inline 'events' list)")
        _check_json_dicts(self, _SERVE_KWARGS_FIELDS)

    # -- serialization (``_JSONSpec``, ``kind: "serve"``) --------------------
    _kind = "serve"

    def replace(self, **updates) -> "ServeSpec":
        """``dataclasses.replace`` plus dotted-key kwargs merges, like
        ``RunSpec.replace``."""
        return _replace(self, _SERVE_KWARGS_FIELDS, updates)

    # -- builders -----------------------------------------------------------
    def to_run_spec(self, **overrides) -> RunSpec:
        """The synchronous RunSpec this service reduces to at K =
        n_clients and zero latency: the sync-parity reference, and the
        config / experiment builder the service reuses."""
        base = dict(
            task=self.task, arch=self.arch, method=self.method,
            n_workers=self.n_clients, n_byz=self.n_byz, attack=self.attack,
            aggregator=self.aggregator, bucket_size=self.bucket_size,
            agg_mode=self.agg_mode, compressor=self.compressor,
            p=1.0, lr=self.lr, steps=self.rounds, seed=self.seed,
            trace=self.trace,
            method_kwargs=dict(self.method_kwargs),
            attack_kwargs=dict(self.attack_kwargs),
            aggregator_kwargs=dict(self.aggregator_kwargs),
            compressor_kwargs=dict(self.compressor_kwargs),
            data_kwargs=dict(self.data_kwargs))
        base.update(overrides)
        return RunSpec(**base)

    def build(self, device=None):
        """-> ``serve.service.AggregationService`` on ``device`` (None:
        the card)."""
        from repro_torch.serve import service
        return service.AggregationService(self, device)

    def run(self, device=None, **run_kw):
        """Build on ``device`` and drive the service for ``rounds`` fired
        rounds."""
        return self.build(device).run(**run_kw)
