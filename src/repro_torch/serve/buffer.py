"""Double-buffered device-resident update buffer (port of
``repro/serve/buffer.py``).

The service ingests one update at a time (a row of the in-flight store)
while the previously filled buffer may still feed an aggregation queued
on the card: a double buffer. Both halves are stacked ``(K, ...)`` trees
on the in-flight store's device:

  * ``offer`` copies the client's in-flight row into the next free slot
    of the open half, in place (one ``copy_`` per leaf, no buffer copy).
  * ``swap`` hands the filled tree (and its per-slot host metadata:
    client id, dispatch version, sequence number) to the caller and opens
    a fresh half, a new allocation: the caller may still hold the old
    half for an aggregation or a trace.

PyTorch has no buffer donation, so the reference's ``donate`` option is
gone: ``offer`` writes in place either way.

Sequence-number dedup is enforced here: client ``seq`` numbers are
per-client monotone (``arrivals``), so an update is accepted iff its seq
is strictly newer than the client's last accepted one (network replays:
``rej_replay``) and the client does not already hold a slot in the open
half (one contribution per client a round: ``rej_dup_client``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tree_utils as tu


class DoubleBuffer:
    """K-slot double buffer with per-client sequence dedup."""

    def __init__(self, capacity: int, n_clients: int):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.capacity = int(capacity)
        self.n_clients = int(n_clients)
        self._buf = None                     # open half, (K, ...) tree
        self.count = 0
        # per-slot metadata of the open half (host side)
        self.clients = np.full(capacity, -1, np.int64)
        self.versions = np.zeros(capacity, np.int64)
        self.seqs = np.full(capacity, -1, np.int64)
        # dedup state
        self.last_accepted = np.full(n_clients, -1, np.int64)
        self.in_buffer = np.zeros(n_clients, bool)
        self.stats = {"accepted": 0, "rej_replay": 0, "rej_dup_client": 0}

    def _alloc_like(self, inflight: dict) -> dict:
        k = self.capacity
        return tu.tree_map(lambda a: torch.zeros((k,) + tuple(a.shape[1:]),
                                                 dtype=a.dtype,
                                                 device=a.device), inflight)

    # -- ingest -------------------------------------------------------------
    def offer(self, client: int, seq: int, version: int, inflight) -> bool:
        """Try to admit the client's in-flight row (``inflight[client]``)
        into the next free slot. Returns False (and counts why) when dedup
        rejects it; the caller fires when ``full()``."""
        if self.count >= self.capacity:
            raise RuntimeError("offer() on a full buffer — fire first")
        if seq <= self.last_accepted[client]:
            self.stats["rej_replay"] += 1
            return False
        if self.in_buffer[client]:
            self.stats["rej_dup_client"] += 1
            return False
        if self._buf is None:
            self._buf = self._alloc_like(inflight)
        slot = self.count
        for dst, src in zip(tu.leaves(self._buf), tu.leaves(inflight)):
            dst[slot].copy_(src[int(client)])
        self.clients[slot] = client
        self.versions[slot] = version
        self.seqs[slot] = seq
        self.last_accepted[client] = seq
        self.in_buffer[client] = True
        self.count += 1
        self.stats["accepted"] += 1
        return True

    def full(self) -> bool:
        return self.count == self.capacity

    # -- handoff ------------------------------------------------------------
    def swap(self):
        """Close the open half: return ``(tree, clients, versions, seqs)``
        and start a fresh empty half (new offers never write into the
        returned tree)."""
        if self._buf is None:
            raise RuntimeError("swap() on an empty buffer")
        out = (self._buf, self.clients.copy(), self.versions.copy(),
               self.seqs.copy())
        self._buf = None
        self.count = 0
        self.clients[:] = -1
        self.versions[:] = 0
        self.seqs[:] = -1
        self.in_buffer[:] = False
        return out
