"""Deterministic arrival processes for the streaming service (port of
``repro/serve/arrivals.py``, numpy only, event for event the reference's
stream: a trace saved by either package replays in the other).

The service consumes a totally-ordered stream of ``Arrival`` events in
closed-loop *virtual* time: every client has exactly one update in flight,
and when that update arrives (or is dropped in flight) the client
immediately re-dispatches, so arrival times are a pure function of the
per-dispatch latency draws — never of anything the service computes. That
purity is what makes every chaos scenario replayable: the same
``(mode, n_clients, seed, knobs)`` tuple regenerates the identical event
stream on any host, a trace can be precomputed to JSON and replayed
bit-identically, and crash-recovery resumes mid-stream by regenerating and
skipping the first ``cursor`` events (no RNG state to checkpoint).

Latency models (``mode``):
  * ``const``     — every dispatch takes exactly ``latency`` virtual
                    seconds. With no chaos knobs this is the lockstep
                    limit: all n clients' seq-k updates arrive in one
                    tick: the sync-parity regime.
  * ``exp``       — i.i.d. Exponential(``mean_latency``) per dispatch
                    (Poisson-style traffic).
  * ``lognormal`` — LogNormal with ``sigma`` spread around
                    ``mean_latency`` (heavy-tailed stragglers).
  * ``trace``     — replay a JSON event list verbatim (``path=`` or
                    inline ``events=``).

Chaos knobs (all seeded, all off by default):
  * ``straggler_frac`` / ``straggler_factor`` — a fixed random subset of
    clients whose every latency is multiplied by the factor.
  * ``dropout`` — per-dispatch probability the update is lost in flight;
    the event still appears (``dropped=True``) so the service observes the
    timeout and the client re-dispatches, but nothing is ingested.
  * ``duplicate`` / ``replay_lag`` — per-dispatch probability the network
    delivers a second copy ``replay_lag`` after the first
    (``replay=True``); the buffer's sequence-number dedup must reject it.
  * ``crash`` / ``recovery_lag`` — per-dispatch probability the client
    process dies mid-flight (the fault layer's process-site chaos,
    DESIGN.md §6): the event appears (``crashed=True``) so the server
    observes the loss, nothing is ingested, and the client only re-dispatches
    ``recovery_lag`` after the observation (process restart).
  * ``hang`` / ``hang_lag`` — per-dispatch probability the client wedges
    and recovers: the update still arrives (``hung=True``) but
    ``hang_lag`` late, so it lands stale and the staleness weighting
    discounts it.

The fault labels are observational: a crash behaves exactly like a drop
(plus the recovery lag already baked into the timeline) and a hang like a
straggler's late arrival, so relabeling ``crashed -> dropped`` and
clearing ``hung`` in a saved trace replays the IDENTICAL parameter
trajectory — the invariant the service's tests pin. New chaos draws are
gated on their knobs, so streams with ``crash = hang = 0`` are
bit-identical to the pre-fault generator.

Events at the same virtual instant are ordered by ``(seq, replay,
client)``: one "wave" of simultaneous arrivals is ingested (and any full
buffer fired) before anyone re-dispatches, which is what makes the
``const``-latency limit reproduce the synchronous round exactly.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
from typing import Iterator, Optional

import numpy as np


ARRIVAL_MODES = ("const", "exp", "lognormal", "trace")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One delivery attempt reaching the server at virtual time ``t``."""
    t: float
    client: int
    seq: int                  # per-client dispatch sequence number
    replay: bool = False      # duplicate delivery of an already-sent update
    dropped: bool = False     # lost in flight: observe + re-dispatch only
    crashed: bool = False     # client process died mid-flight (no ingest;
    #                           re-dispatch recovery_lag after observation)
    hung: bool = False        # client wedged: arrival delayed by hang_lag

    def to_dict(self) -> dict:
        return {"t": self.t, "client": self.client, "seq": self.seq,
                "replay": self.replay, "dropped": self.dropped,
                "crashed": self.crashed, "hung": self.hung}

    @classmethod
    def from_dict(cls, d: dict) -> "Arrival":
        return cls(t=float(d["t"]), client=int(d["client"]),
                   seq=int(d["seq"]), replay=bool(d.get("replay", False)),
                   dropped=bool(d.get("dropped", False)),
                   crashed=bool(d.get("crashed", False)),
                   hung=bool(d.get("hung", False)))


class ArrivalProcess:
    """Seeded closed-loop event generator over ``n_clients`` clients.

    ``events(start=cursor)`` yields ``Arrival``s in virtual-time order
    forever (or until the trace is exhausted); the stream from a given
    ``start`` index is identical on every call — resume == regenerate+skip.
    """

    def __init__(self, mode: str, n_clients: int, seed: int = 0, *,
                 latency: float = 1.0, mean_latency: float = 1.0,
                 sigma: float = 1.0, straggler_frac: float = 0.0,
                 straggler_factor: float = 10.0, dropout: float = 0.0,
                 duplicate: float = 0.0, replay_lag: float = 0.5,
                 crash: float = 0.0, recovery_lag: float = 2.0,
                 hang: float = 0.0, hang_lag: float = 5.0,
                 path: Optional[str] = None, events: Optional[list] = None):
        if mode not in ARRIVAL_MODES:
            raise ValueError(f"mode {mode!r} not in {ARRIVAL_MODES}")
        if n_clients < 1:
            raise ValueError(f"n_clients={n_clients} must be >= 1")
        for nm, v in (("dropout", dropout), ("duplicate", duplicate),
                      ("straggler_frac", straggler_frac),
                      ("crash", crash), ("hang", hang)):
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{nm}={v} must be in [0, 1)")
        self.mode = mode
        self.n_clients = int(n_clients)
        self.seed = int(seed)
        self.latency = float(latency)
        self.mean_latency = float(mean_latency)
        self.sigma = float(sigma)
        self.straggler_frac = float(straggler_frac)
        self.straggler_factor = float(straggler_factor)
        self.dropout = float(dropout)
        self.duplicate = float(duplicate)
        self.replay_lag = float(replay_lag)
        self.crash = float(crash)
        self.recovery_lag = float(recovery_lag)
        self.hang = float(hang)
        self.hang_lag = float(hang_lag)
        self._trace: Optional[list] = None
        if mode == "trace":
            if events is None:
                if path is None:
                    raise ValueError("mode='trace' needs path= or events=")
                with open(path) as f:
                    events = json.load(f)
            self._trace = [e if isinstance(e, Arrival) else
                           Arrival.from_dict(e) for e in events]

    # -- trace persistence --------------------------------------------------
    def save_trace(self, path: str, n_events: int) -> list:
        """Materialize the first ``n_events`` events to JSON (-> a
        ``mode='trace'`` process replays them bit-identically)."""
        evs = []
        for ev in self.events():
            evs.append(ev)
            if len(evs) >= n_events:
                break
        with open(path, "w") as f:
            json.dump([e.to_dict() for e in evs], f, indent=1)
        return evs

    # -- the event stream ---------------------------------------------------
    def events(self, start: int = 0) -> Iterator[Arrival]:
        """Yield arrivals in ``(t, seq, replay, client)`` order, skipping
        the first ``start`` (the resume cursor)."""
        it = (iter(self._trace) if self._trace is not None
              else self._simulate())
        for i, ev in enumerate(it):
            if i >= start:
                yield ev

    def _simulate(self) -> Iterator[Arrival]:
        rng = np.random.default_rng(self.seed)
        n = self.n_clients
        # fixed straggler subset, drawn once (chaos is in the latencies)
        factors = np.ones(n)
        k = int(round(self.straggler_frac * n))
        if k:
            factors[rng.choice(n, size=k, replace=False)] = \
                self.straggler_factor

        def draw(client: int) -> float:
            if self.mode == "const":
                lat = self.latency
            elif self.mode == "exp":
                lat = float(rng.exponential(self.mean_latency))
            else:                                          # lognormal
                lat = float(rng.lognormal(
                    mean=np.log(max(self.mean_latency, 1e-12)),
                    sigma=self.sigma))
            return lat * float(factors[client])

        # heap entries sort by (t, seq, replay, client): simultaneous
        # arrivals form one wave, originals before their replays
        heap: list = []

        def dispatch(client: int, seq: int, t0: float) -> None:
            t_arr = t0 + draw(client)
            dropped = bool(rng.random() < self.dropout)
            # fault draws are gated on their knobs so a crash=hang=0
            # process consumes the identical RNG stream as before
            crashed = hung = False
            if self.crash:
                crashed = not dropped and bool(rng.random() < self.crash)
            if self.hang:
                hung = not dropped and not crashed and \
                    bool(rng.random() < self.hang)
            if hung:
                t_arr += self.hang_lag
            heapq.heappush(heap, (t_arr, seq, 0, client, dropped, crashed,
                                  hung))
            if not dropped and not crashed and self.duplicate and \
                    rng.random() < self.duplicate:
                heapq.heappush(
                    heap, (t_arr + self.replay_lag, seq, 1, client,
                           False, False, False))

        for c in range(n):
            dispatch(c, 0, 0.0)
        while True:
            t, seq, rep, client, dropped, crashed, hung = heapq.heappop(heap)
            yield Arrival(t=t, client=client, seq=seq, replay=bool(rep),
                          dropped=dropped, crashed=crashed, hung=hung)
            if not rep:
                # closed loop: the client re-dispatches the moment its
                # previous update resolves (arrives or times out); a
                # crashed client first restarts, costing recovery_lag
                dispatch(client, seq + 1,
                         t + (self.recovery_lag if crashed else 0.0))


def make_arrivals(spec) -> ArrivalProcess:
    """Build the spec'd process (``api.spec.ServeSpec``)."""
    return ArrivalProcess(spec.arrival, spec.n_clients, seed=spec.seed,
                          **spec.arrival_kwargs)
