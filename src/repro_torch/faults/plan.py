"""Seeded fault plans, the replayable chaos schedule (port of
``repro/faults/plan.py``, a copy: the port imports nothing of the
reference).

A ``FaultPlan`` is a pure description: which fault kinds fire, with what
per-round probability, on which workers. Every random draw the plan induces
is derived from ``fold_in``s of the engine's own per-round attack key plus
the plan seed (``inject.fault_key``), so a chaotic run is replayable
bit for bit from ``(spec, plan)`` alone. The plan is static config,
JSON-round-trippable through ``RunSpec.faults``.

Fault registry (``FAULTS``):

* ``nan_grad``     — tensor: a worker's candidate rows become NaN
                     (fp-overflow gradients).
* ``inf_blowup``   — tensor: candidate rows become +inf (diverged local
                     step).
* ``stale_replay`` — tensor: candidate rows become zero (a replayed,
                     already-applied update; finite, so invisible to the
                     non-finite guard by design: the robust rules are
                     the containment layer).
* ``corrupt_wire`` — wire: random bit-flips XORed into every payload array
                     of the worker's ``WireCandidates`` rows.
* ``crash``        — process: the worker subprocess / serve client dies
                     (exec retry + serve recovery handle it).
* ``hang``         — process: the worker stalls past its timeout.

Kinds are grouped by injection site: TENSOR + WIRE kinds act inside
``engine.message_phase`` (message faults); PROCESS kinds act in
``exec.worker`` (``exec.scheduler.process_fault`` picks the cells) and
``serve.arrivals`` (the ``crash`` and ``hang`` knobs of a client's
dispatch).
"""
from __future__ import annotations

import dataclasses
import difflib
import json
from typing import Tuple

FAULTS = ("nan_grad", "inf_blowup", "stale_replay", "corrupt_wire",
          "crash", "hang")
TENSOR_FAULTS = ("nan_grad", "inf_blowup", "stale_replay")
WIRE_FAULTS = ("corrupt_wire",)
PROCESS_FAULTS = ("crash", "hang")
MESSAGE_FAULTS = TENSOR_FAULTS + WIRE_FAULTS

# Row-fill values for the tensor kinds (stale_replay replays a no-op
# update: zeros, finite on purpose).
TENSOR_FILL = {"nan_grad": float("nan"), "inf_blowup": float("inf"),
               "stale_replay": 0.0}


def _unknown_kind(kind: str) -> str:
    close = difflib.get_close_matches(kind, FAULTS, n=1)
    hint = f" — did you mean {close[0]!r}?" if close else ""
    return f"unknown fault kind {kind!r}{hint} (known: {', '.join(FAULTS)})"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault kind's schedule: fire with ``prob`` per round, restricted
    to ``workers`` (empty tuple = every worker is eligible)."""
    kind: str
    prob: float = 1.0
    workers: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in FAULTS:
            raise ValueError(_unknown_kind(self.kind))
        if not 0.0 <= float(self.prob) <= 1.0:
            raise ValueError(f"fault prob must be in [0, 1], got {self.prob}")
        object.__setattr__(self, "prob", float(self.prob))
        ws = tuple(int(w) for w in self.workers)
        if any(w < 0 for w in ws):
            raise ValueError(f"fault workers must be >= 0, got {ws}")
        object.__setattr__(self, "workers", ws)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "prob": self.prob,
                "workers": list(self.workers)}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The full seeded chaos schedule for one run."""
    seed: int = 0
    faults: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "seed", int(self.seed))
        fs = tuple(f if isinstance(f, FaultSpec) else FaultSpec(**f)
                   for f in self.faults)
        object.__setattr__(self, "faults", fs)

    # -- site selectors ----------------------------------------------------
    def of_kinds(self, kinds) -> Tuple[FaultSpec, ...]:
        return tuple(f for f in self.faults if f.kind in kinds)

    @property
    def message_faults(self) -> Tuple[FaultSpec, ...]:
        return self.of_kinds(MESSAGE_FAULTS)

    @property
    def tensor_faults(self) -> Tuple[FaultSpec, ...]:
        return self.of_kinds(TENSOR_FAULTS)

    @property
    def wire_faults(self) -> Tuple[FaultSpec, ...]:
        return self.of_kinds(WIRE_FAULTS)

    @property
    def process_faults(self) -> Tuple[FaultSpec, ...]:
        return self.of_kinds(PROCESS_FAULTS)

    def worst_case_faulty(self, n: int) -> int:
        """Upper bound on simultaneously message-faulted workers — the f in
        the 2·(n_byz + f) < n budget check (spec validation)."""
        hit = set()
        for f in self.message_faults:
            if f.prob <= 0.0:
                continue
            hit |= set(f.workers) if f.workers else set(range(n))
        return len(hit & set(range(n)))

    # -- (de)serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "faults": [f.to_dict() for f in self.faults]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        if not isinstance(d, dict):
            raise TypeError(f"FaultPlan dict expected, got {type(d).__name__}")
        extra = set(d) - {"seed", "faults"}
        if extra:
            raise ValueError(f"unknown FaultPlan keys {sorted(extra)} "
                             "(expected: seed, faults)")
        faults = []
        for f in d.get("faults", ()):
            if isinstance(f, str):         # shorthand: ["nan_grad", ...]
                f = {"kind": f}
            unknown = set(f) - {"kind", "prob", "workers"}
            if unknown:
                raise ValueError(f"unknown FaultSpec keys {sorted(unknown)} "
                                 "(expected: kind, prob, workers)")
            faults.append(FaultSpec(**f))
        return cls(seed=d.get("seed", 0), faults=tuple(faults))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))


def as_plan(obj) -> "FaultPlan | None":
    """Coerce ``RunSpec.faults``-style input into a FaultPlan. ``None`` or
    an empty dict means no plan."""
    if obj is None or obj == {}:
        return None
    if isinstance(obj, FaultPlan):
        return obj
    return FaultPlan.from_dict(obj)
