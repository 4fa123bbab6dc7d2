"""The buffered-asynchronous robust-aggregation round engine (port of
``repro/serve/service.py``).

``AggregationService`` replaces the synchronous round barrier with a
FedBuff-style protocol over the unchanged aggregation stack: clients
dispatch updates continuously (``arrivals``), a double buffer admits them
with sequence dedup (``buffer``), and every time the buffer holds
``buffer_size = K`` updates the service fires lines 9-10 of the paper's
round (omniscient attack, robust aggregation) through
``engine.ingest_message_phase``, with

  * the byzantine mask over the *buffered* set (whichever updates sit in
    the fired buffer, not a static worker prefix);
  * FedBuff staleness weighting ``s(τ) = 1/sqrt(1+τ)`` (τ = fires since
    the update's dispatch), given only when some τ > 0: candidates are
    scaled by ``K·s(τ_i)/Σ_j s(τ_j)`` and then robustly aggregated, so
    ``rule="mean"`` gives the FedBuff weighted mean; on the kernels the
    scale rides in the bucket operator W.

Virtual-time semantics (what makes every run replayable and the sync
limit exact): events at one instant are processed as a wave; a fire ends
the current segment, and clients (re)dispatch at segment ends, so a
client whose update was just consumed pulls the post-fire model; with
``const`` latency, no chaos and K = n_clients the service is the
synchronous engine's trajectory bit for bit. Dispatch is lazy and
batched: a (re)dispatching client is only marked pending, and one
``estimator.round`` over every client (the engine's own candidates, the
runner's key schedule) makes every pending client's update when one of
them first arrives or a fire needs the params to advance; its result is
cached for the version, and only pending rows are committed.

Crash safety: every fired round can be journaled through ``exec.ledger``
(round, cursor, staleness, byzantines in the buffer, dedup counters, an
optional params digest) and checkpoints snapshot the whole service state
(engine state, in-flight store, dispatch versions, dedup table, event
cursor) right after a fire, in the reference's layout, so a snapshot of
either package resumes in the other. Resume reloads the snapshot and
replays the arrival stream from the cursor, so a killed and resumed run
ends bit for bit as the uninterrupted one.

Everything runs on the experiment's device: the card unless the caller
asks for the CPU. Where the reference blocks on the params, the port
synchronizes the card (``torch.cuda.synchronize``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.core import engine
from repro_torch.core import tree_utils as tu
from repro_torch.serve.arrivals import make_arrivals
from repro_torch.serve.buffer import DoubleBuffer

_BUF_STATS = ("accepted", "rej_replay", "rej_dup_client")


def staleness_weights(tau: np.ndarray) -> np.ndarray:
    """FedBuff weights over one buffer: ``K * s(τ_i) / Σ_j s(τ_j)`` with
    ``s(τ) = 1/sqrt(1+τ)``, in float64, rounded to float32. A plain mean
    of the scaled candidates is the FedBuff weighted mean; all-fresh
    buffers (τ ≡ 0) give exactly 1."""
    s = 1.0 / np.sqrt(1.0 + tau.astype(np.float64))
    return (len(s) * s / s.sum()).astype(np.float32)


@dataclasses.dataclass
class ServeResult:
    """What a service run hands back (the streaming twin of RunResult)."""
    spec: Any
    history: list                  # one metrics dict per fired round
    state: dict                    # final engine state (params, g, ...)
    stats: dict                    # accepted / rejected / dropped counters
    n_params: int
    wall_s: float
    updates_per_s: float           # accepted ingests per wall second
    fire_latencies_s: list         # per fenced fire: every fire with
    # sync_each_fire, else every latency_sample_every-th
    staleness_hist: dict = dataclasses.field(default_factory=dict)
    # tau -> count over every buffered entry of every fired round
    traces: list = dataclasses.field(default_factory=list)
    # host RoundTrace dicts, one per fired round (spec.trace runs only)

    @property
    def params(self):
        return self.state["params"]

    @property
    def final(self) -> dict:
        return self.history[-1] if self.history else {}

    def latency_percentiles(self) -> dict:
        if not self.fire_latencies_s:
            return {}
        lat = np.asarray(self.fire_latencies_s)
        return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p99_ms": float(np.percentile(lat, 99) * 1e3)}

    def staleness_percentiles(self) -> dict:
        """Percentiles of the per-entry staleness, expanded from the
        histogram ({} before the first fire)."""
        if not self.staleness_hist:
            return {}
        taus = np.repeat([int(t) for t in self.staleness_hist],
                         [int(c) for c in self.staleness_hist.values()])
        return {"staleness_p50": float(np.percentile(taus, 50)),
                "staleness_p90": float(np.percentile(taus, 90)),
                "staleness_worst": int(taus.max())}

    def detection_summary(self, frac: float = 0.5) -> dict:
        from repro_torch.obs import detect
        return detect.summarize(self.traces, frac)

    def to_dict(self) -> dict:
        out = {"spec": self.spec.to_dict(), "n_params": self.n_params,
               "wall_s": self.wall_s, "updates_per_s": self.updates_per_s,
               "stats": dict(self.stats),
               **self.latency_percentiles(),
               **self.staleness_percentiles(),
               "staleness_hist": {str(k): int(v) for k, v in
                                  sorted(self.staleness_hist.items())},
               "history": self.history}
        if self.traces:
            out["detection"] = self.detection_summary()
        return out


class AggregationService:
    """Buffered-async service over an ``api.runner.Experiment``, on
    ``device`` (None: the card)."""

    def __init__(self, spec, device=None):
        self.spec = spec
        self.exp = spec.to_run_spec().build(device)
        self.device = self.exp.device
        self.cfg = self.exp.cfg
        self.est = self.exp.method.estimator
        if self.est.update_params_first or not self.est.streamable:
            raise ValueError(
                f"method {spec.method!r} cannot drive the streaming "
                "service (ServeSpec validates this — hand-built spec?)")
        self.n = spec.n_clients
        self.k = spec.buffer_size

    # -- the round's pieces -------------------------------------------------
    def _flush(self, state, batch, anchor, k_step):
        """The candidates of every client at the current version: the
        engine's own ``estimator.round``, the runner's key schedule. Made
        at most once a version (keys, batch and params are functions of
        the version alone) and committed per client by ``_commit``."""
        cfg, est = self.cfg, self.est
        batch = engine.maybe_corrupt(cfg, self.exp.corrupt_fn, batch)
        anchor = engine.maybe_corrupt(cfg, self.exp.corrupt_fn, anchor)
        keys = dict(zip(est.rng, R.split(k_step, len(est.rng))))
        ro = est.round(cfg, self.exp.loss_fn, state, state["params"],
                       state["params"], batch, anchor, keys)
        from repro_torch.core import wire
        if isinstance(ro.cand, wire.WireCandidates):
            raise TypeError(
                "the service buffers dense updates, but this "
                "compressor+backend takes the packed wire path; use "
                "agg_mode='gspmd' or a non-wire compressor")
        return ro.cand, dict(ro.updates or {}), ro.loss

    def _commit(self, state, inflight, cand, updates, pending):
        """Commit the cached candidates (and any stacked estimator state,
        e.g. sgdm's worker momenta) on the pending rows only: the other
        clients keep their older in-flight updates, which is where
        staleness comes from. Re-committing a row within a version writes
        the same values."""

        def sel(new, old):
            if new.shape[:1] != (self.n,):
                return new                     # not stacked per client
            m = pending.reshape((-1,) + (1,) * (new.dim() - 1))
            return torch.where(m, new, old)

        new_inflight = (tu.tree_map(sel, cand, inflight)
                        if inflight is not None else cand)
        new_state = dict(state)
        for k, v in updates.items():
            new_state[k] = tu.tree_map(sel, v, state[k])
        return new_state, new_inflight

    def _fire(self, state, buf, byz_mask, weights, k_attack, k_agg):
        """Lines 9-10 over the buffered set and the server's step; with
        ``spec.trace`` the telemetry twin (the same calls, and the fired
        round's RoundTrace over the buffered entries). -> (state, |g|,
        RoundTrace or None)."""
        cfg = self.cfg
        out = engine.ingest_message_phase(
            cfg, k_attack, k_agg, buf, byz_mask=byz_mask, weights=weights,
            trace=self.spec.trace)
        g, rt = out if self.spec.trace else (out, None)
        new_params, new_opt = engine.param_update(
            cfg, state["params"], g, state["opt_state"])
        new_state = {**state, "params": new_params, "g": g,
                     "opt_state": new_opt, "step": state["step"] + 1}
        return new_state, torch.sqrt(tu.tree_norm_sq(g)), rt

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the service state snapshot (checkpoint payload) --------------------
    def _snapshot(self, state, inflight, svc) -> dict:
        """The reference's layout; host arrays as CPU tensors."""
        def host(a, dtype):
            return torch.from_numpy(np.array(a, dtype=dtype))

        return {
            "engine": state,
            "inflight": inflight,
            "pending": host(svc["pending"], bool),
            "disp_version": host(svc["disp_version"], np.int64),
            "last_accepted": host(svc["last_accepted"], np.int64),
            "counters": host([svc["cursor"], svc["version"], svc["dropped"],
                              svc["crashed"], svc["hung"]], np.int64),
            "buf_stats": host([svc["stats"][k] for k in _BUF_STATS],
                              np.int64),
        }

    # -- the event loop -----------------------------------------------------
    def run(self, rounds: Optional[int] = None, *,
            ledger_path: Optional[str] = None,
            checkpoint: Optional[str] = None,
            checkpoint_every: Optional[int] = None,
            resume: Optional[str] = None,
            sync_each_fire: bool = False,
            digest: bool = False,
            stop_after_events: Optional[int] = None,
            max_events: Optional[int] = None,
            sink=None,
            metrics_jsonl: Optional[str] = None,
            latency_sample_every: int = 8,
            verbose: bool = False) -> ServeResult:
        """Drive the service for ``rounds`` fired rounds.

        ``sync_each_fire`` synchronizes the card after every fire (per-fire
        latency percentiles); off, the host goes on ingesting while the
        card aggregates, and every ``latency_sample_every``-th fire is
        fenced instead (0 disables sampling). ``digest`` adds a sha1 of
        the post-fire params to each ledger record (a device read).
        ``stop_after_events`` aborts after that many arrival events
        without checkpointing (the kill in the kill-and-resume checks).
        ``resume`` reloads a checkpoint prefix and replays the arrival
        stream from its cursor. ``sink`` / ``metrics_jsonl``: a
        ``repro_torch.obs.sink.MetricSink`` (and / or a JSONL path). In
        the loop the service emits host-side events only (a per-fire
        buffer-occupancy gauge, per-reason counters, spans for fenced
        fires); the per-round ``{"type": "round"}`` and ``{"type":
        "trace"}`` events follow the final synchronization. With the
        profiler's step markers on (``obs.profile``), each fire is one
        ``round`` range.
        """
        from repro_torch.obs.profile import round_range
        spec = self.spec
        rounds = spec.rounds if rounds is None else int(rounds)
        exp = self.exp
        n, K = self.n, self.k
        dev = self.device
        own_jsonl = None
        if metrics_jsonl:
            from repro_torch.obs.sink import FanoutSink, JsonlSink
            own_jsonl = JsonlSink(metrics_jsonl)
            sink = (FanoutSink(sink, own_jsonl) if sink is not None
                    else own_jsonl)

        key = R.PRNGKey(spec.seed, device=dev)
        k_init, k_run = R.split(key)
        params = exp.init_params(k_init)
        n_params = int(tu.tree_size(params))
        state = exp.method.init(params, exp.anchor(0), k_run)

        buffer = DoubleBuffer(K, n)
        svc = {"cursor": 0, "version": 0, "dropped": 0,
               "crashed": 0, "hung": 0,
               "pending": np.ones(n, bool),
               "disp_version": np.zeros(n, np.int64),
               "last_accepted": buffer.last_accepted,
               "stats": buffer.stats}
        inflight = None
        last_loss = torch.zeros((), dtype=torch.float32, device=dev)

        if resume:
            from repro_torch.checkpoint import load_checkpoint
            # in-flight rows exist for every client after the first flush,
            # so the template holds (n, ...) float32 candidate rows
            inflight = tu.tree_broadcast_leading(
                tu.tree_map(lambda a: torch.zeros_like(
                    a, dtype=torch.float32), params), n)
            snap, _ = load_checkpoint(resume, like=self._snapshot(
                state, inflight, svc))
            state, inflight = snap["engine"], snap["inflight"]
            svc["pending"] = snap["pending"].numpy().astype(bool)
            svc["disp_version"] = snap["disp_version"].numpy().astype(
                np.int64)
            buffer.last_accepted[:] = snap["last_accepted"].numpy()
            cur, ver, dropped, crashed, hung = (
                int(x) for x in snap["counters"].tolist())
            svc.update(cursor=cur, version=ver, dropped=dropped,
                       crashed=crashed, hung=hung)
            for k, v in zip(_BUF_STATS, snap["buf_stats"].tolist()):
                buffer.stats[k] = int(v)
            if verbose:
                print(f"[serve] resumed at round {ver}, cursor {cur}")
        svc["last_accepted"] = buffer.last_accepted

        ledger = None
        if ledger_path:
            from repro_torch.exec.ledger import Ledger
            ledger = Ledger(ledger_path)
        if checkpoint:
            from repro_torch.checkpoint import save_checkpoint

        def k_version(v):
            k_step, k_batch = R.split(R.fold_in(k_run, v + 1))
            return k_step, k_batch

        # per-version candidate cache: within one version every dispatch
        # sends the same candidate, so the estimator's round runs at most
        # once a version; later flushes commit cached rows
        cache = {"version": -1, "cand": None, "updates": None}

        def flush():
            nonlocal state, inflight, last_loss
            v = svc["version"]
            if cache["version"] != v:
                k_step, k_batch = k_version(v)
                cand, upd, last_loss = self._flush(
                    state, exp.minibatch(v, k_batch), exp.anchor(v), k_step)
                cache.update(version=v, cand=cand, updates=upd)
            mask = torch.as_tensor(np.array(svc["pending"]), device=dev)
            state, inflight = self._commit(
                state, inflight, cache["cand"], cache["updates"], mask)
            svc["pending"][:] = False

        history: list = []
        fire_lat: list = []
        redispatch: list = []
        stale_hist: dict = {}
        dev_traces: list = []      # device RoundTraces; to the host at the end
        occ_sum = 0
        occ_n = 0

        def _finish(result: ServeResult) -> ServeResult:
            """Emit the per-round / trace events (after the final
            synchronization) and close any sink this call opened."""
            if sink is not None:
                for i, m in enumerate(result.history):
                    sink.emit({"type": "round", **m})
                    if i < len(result.traces):
                        sink.emit({"type": "trace", "round": m["round"],
                                   **result.traces[i]})
                if result.staleness_hist:
                    sink.emit({"type": "gauge", "name": "staleness_hist",
                               "value": {str(k): int(v) for k, v in sorted(
                                   result.staleness_hist.items())}})
            if own_jsonl is not None:
                own_jsonl.close()
            return result

        if svc["version"] >= rounds:       # resumed a finished run
            return _finish(self._result(history, state, buffer, svc,
                                        fire_lat, 0.0, n_params))
        start_cursor = svc["cursor"]
        start_round = svc["version"]
        events = self.arrival_process().events(start=start_cursor)
        budget = (max_events if max_events is not None
                  else 1000 + 200 * max(rounds, 1) * K)
        t0 = time.time()
        stop = False
        prev_t = None

        def end_segment():
            """(Re)dispatch every client whose update resolved in the
            segment that just closed, at the current model version."""
            for c in redispatch:
                svc["pending"][c] = True
                svc["disp_version"][c] = svc["version"]
            redispatch.clear()

        for ev in events:
            if prev_t is not None and ev.t != prev_t:
                end_segment()                      # wave boundary
            prev_t = ev.t
            svc["cursor"] += 1
            if not ev.replay:
                # the client re-dispatches at the end of this segment (a
                # fire, so checkpoints capture it, or the wave boundary)
                redispatch.append(ev.client)
            if ev.dropped or ev.crashed:
                # a crash is observationally a drop: nothing is ingested,
                # the client re-dispatches (the recovery lag is in the
                # timeline); only the counter differs
                svc["dropped" if ev.dropped else "crashed"] += 1
            else:
                if ev.hung:
                    svc["hung"] += 1   # late but delivered; ingested
                if svc["pending"][ev.client] and \
                        ev.seq > buffer.last_accepted[ev.client] and \
                        not buffer.in_buffer[ev.client]:
                    flush()                        # lazy batched dispatch
                offered = buffer.offer(ev.client, ev.seq,
                                       svc["disp_version"][ev.client],
                                       inflight)
                occ_sum += buffer.count            # occupancy sample per
                occ_n += 1                         # offer (host ints only)
                if offered and buffer.full():
                    if np.any(svc["pending"]):
                        flush()                    # params advance next
                    buf, clients, versions, _ = buffer.swap()
                    r = svc["version"]
                    tau = r - versions
                    byz_mask = torch.as_tensor(clients < spec.n_byz,
                                               device=dev)
                    weighted = (spec.staleness == "fedbuff"
                                and bool(np.any(tau > 0)))
                    w = (torch.as_tensor(staleness_weights(tau), device=dev)
                         if weighted else None)
                    k_step, _ = k_version(r)
                    keys = dict(zip(self.est.rng,
                                    R.split(k_step, len(self.est.rng))))
                    for t in tau.tolist():
                        stale_hist[int(t)] = stale_hist.get(int(t), 0) + 1
                    # fence this fire? always with sync_each_fire, else
                    # every Nth fire (sampled latency percentiles)
                    fence = sync_each_fire or (
                        latency_sample_every and (r - start_round)
                        % max(latency_sample_every, 1) == 0)
                    t_fire = time.perf_counter()
                    with round_range():
                        state, g_norm, rt = self._fire(
                            state, buf, byz_mask, w, keys["attack"],
                            keys["agg"])
                    if rt is not None:
                        dev_traces.append(rt)
                    if fence:
                        self._sync()
                        lat = time.perf_counter() - t_fire
                        fire_lat.append(lat)
                        if sink is not None:
                            sink.emit({"type": "span", "name": "fire",
                                       "round": r,
                                       "wall_s": round(lat, 6),
                                       "fenced": True})
                    if sink is not None:
                        sink.emit({"type": "gauge",
                                   "name": "buffer_occupancy",
                                   "round": r,
                                   "value": round(occ_sum / max(occ_n, 1),
                                                  4)})
                        for cname in _BUF_STATS:
                            sink.emit({"type": "counter", "name": cname,
                                       "round": r,
                                       "value": int(buffer.stats[cname])})
                        for cname in ("dropped", "crashed", "hung"):
                            sink.emit({"type": "counter", "name": cname,
                                       "round": r,
                                       "value": int(svc[cname])})
                    occ_sum = 0
                    occ_n = 0
                    svc["version"] = r + 1
                    end_segment()                  # contributors redispatch
                    byz_in_buffer = int((clients < spec.n_byz).sum())
                    # the byzantine fraction over the active set (the
                    # buffer), the rule the spec validates against
                    from repro_torch.core.theory import (
                        delta_over_active_set)
                    m = {"round": r, "t_virtual": float(ev.t),
                         "loss": last_loss, "g_norm": g_norm,
                         "staleness_mean": float(tau.mean()),
                         "staleness_max": int(tau.max()),
                         "byz_in_buffer": byz_in_buffer,
                         "delta_active": delta_over_active_set(
                             K, byz_in_buffer),
                         "cursor": svc["cursor"]}
                    history.append(m)
                    if ledger is not None:
                        rec = {k: v for k, v in m.items()
                               if k not in ("loss", "g_norm")}
                        rec.update(accepted=buffer.stats["accepted"],
                                   rej_replay=buffer.stats["rej_replay"],
                                   rej_dup_client=buffer.stats
                                   ["rej_dup_client"],
                                   dropped=svc["dropped"],
                                   crashed=svc["crashed"],
                                   hung=svc["hung"],
                                   wall_s=round(time.time() - t0, 4))
                        if digest:
                            rec["params_sha1"] = params_digest(
                                state["params"])
                        ledger.append(f"round-{r:06d}", "fired", **rec)
                    if verbose:
                        print(f"[serve] round {r:4d} t={ev.t:9.3f} "
                              f"stale(mean={tau.mean():.2f} "
                              f"max={int(tau.max())}) "
                              f"byz={m['byz_in_buffer']}/{K}")
                    if checkpoint and checkpoint_every and \
                            (r + 1 - start_round) % checkpoint_every == 0:
                        save_checkpoint(checkpoint, self._snapshot(
                            state, inflight, svc), step=svc["version"])
                    if svc["version"] >= rounds:
                        stop = True
            if stop:
                break
            if stop_after_events is not None and \
                    svc["cursor"] - start_cursor >= stop_after_events:
                # simulated crash: no checkpoint, state as it is
                return _finish(self._result(
                    history, state, buffer, svc, fire_lat,
                    time.time() - t0, n_params, stale_hist=stale_hist,
                    dev_traces=dev_traces))
            if svc["cursor"] - start_cursor > budget:
                raise RuntimeError(
                    f"consumed {svc['cursor'] - start_cursor} events "
                    f"without reaching {rounds} rounds — dropout/duplicate "
                    "chaos too high or buffer_size too large; raise "
                    "max_events to override")
        self._sync()
        wall = time.time() - t0
        if checkpoint and inflight is not None:
            save_checkpoint(checkpoint, self._snapshot(
                state, inflight, svc), step=svc["version"])
        return _finish(self._result(history, state, buffer, svc, fire_lat,
                                    wall, n_params, stale_hist=stale_hist,
                                    dev_traces=dev_traces))

    def _result(self, history, state, buffer, svc, fire_lat, wall,
                n_params, stale_hist=None, dev_traces=None) -> ServeResult:
        # the history's device scalars to floats, one pass at the end
        for m in history:
            if not isinstance(m.get("loss"), float):
                m["loss"] = float(m["loss"])
                m["g_norm"] = float(m["g_norm"])
        traces: list = []
        if dev_traces:
            # one host pass, after the loop: fires never waited for the
            # telemetry
            from repro_torch.obs import detect as obs_detect
            from repro_torch.obs import trace as obs_trace
            for m, rt in zip(history, dev_traces):
                th = obs_trace.to_host(rt)
                det = obs_detect.detection_metrics(th)
                m["detect_precision"] = det["precision"]
                m["detect_recall"] = det["recall"]
                m["byz_leakage"] = det["byz_leakage"]
                m["n_filtered"] = det["n_filtered"]
                traces.append(th)
        stats = {**buffer.stats, "dropped": svc["dropped"],
                 "crashed": svc["crashed"], "hung": svc["hung"],
                 "events": svc["cursor"], "rounds": svc["version"]}
        return ServeResult(
            spec=self.spec, history=history, state=state, stats=stats,
            n_params=n_params, wall_s=wall,
            updates_per_s=buffer.stats["accepted"] / max(wall, 1e-9),
            fire_latencies_s=fire_lat, staleness_hist=stale_hist or {},
            traces=traces)

    def arrival_process(self):
        return make_arrivals(self.spec)


def params_digest(params: dict) -> str:
    """sha1 over the raw bytes of every leaf, in tree order (a device
    read); equal parameters give the reference's digest."""
    h = hashlib.sha1()
    for leaf in tu.leaves(params):
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()
