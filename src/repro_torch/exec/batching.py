"""Seed groups: cells that differ only in seed, run over one experiment
(port of ``repro/exec/batching.py``).

A cell's signature is its spec minus the ``seed`` field. ``group_cells``
partitions cells by it and ``can_batch`` decides, by the reference's
rules, which groups run as one: the logreg task (the dataset does not
depend on the seed), the gspmd backend, untraced, a method whose
estimator declares ``seed_batchable`` (SAGA's per-worker tables do not),
distinct seeds, at least two cells, and only loop knobs every member
shares (``log_every``, ``warmup``, ``verbose``, ``device``).

The reference runs a group as one ``jax.vmap``-over-seeds step, to pay
one XLA compile a group. The port compiles nothing, and cannot vmap the
round: MARINA's coin and SVRG's refresh are read on the host, and the
kernel launches go through ctypes. So ``run_group`` builds the
``Experiment`` once (the data built once, on the device) and runs the
seeds in turn over it, each through the runner's own loop: every seed
equals its serial run bit for bit. ``stats["step_compiles"]`` is 0, as
nothing is compiled.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Sequence, Tuple

from repro_torch.api.runner import build
from repro_torch.core import estimators

GROUP_AXIS = "seed"

# loop knobs a seed group understands; anything else forces serial cells
_BATCHABLE_RUN_KW = {"log_every", "warmup", "verbose", "device"}


def group_key(spec) -> str:
    """Canonical signature key: the spec dict minus the seed axis."""
    d = spec.to_dict()
    d.pop(GROUP_AXIS, None)
    return json.dumps(d, sort_keys=True)


def group_cells(cells: Sequence[Tuple[str, object]]):
    """[(run_id, spec)] -> [(key, [(run_id, spec), ...])] preserving the
    first-seen order of both groups and members."""
    groups: dict = {}
    order = []
    for run_id, spec in cells:
        key = group_key(spec)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append((run_id, spec))
    return [(key, groups[key]) for key in order]


def can_batch(cells: Sequence[Tuple[str, object]],
              run_kw: Mapping = None) -> bool:
    """True when a same-signature group can run as one group."""
    if len(cells) < 2:
        return False                     # nothing to share
    if run_kw and set(run_kw) - _BATCHABLE_RUN_KW:
        return False                     # callbacks/checkpoints are per-cell
    spec = cells[0][1]
    if spec.task != "logreg":
        return False                     # TokenStream data is seed-baked
    if spec.agg_mode != "gspmd":
        return False                     # the reference's rule, kept
    if getattr(spec, "trace", False):
        return False                     # traces are per-trajectory
    if not estimators.seed_batchable(spec.method):
        return False                     # per-worker tables
    seen = set()
    for _, s in cells:
        if group_key(s) != group_key(spec) or s.seed in seen:
            return False
        seen.add(s.seed)
    return True


def run_group(cells: Sequence[Tuple[str, object]], *, log_every: int = 10,
              warmup: bool = False, verbose: bool = False, device=None):
    """Run one same-signature group over one ``Experiment``.

    Returns ``({run_id: RunResult}, stats)``; each RunResult is the
    runner's own for that seed, so equal to a serial run bit for bit.
    """
    if not can_batch(cells):
        raise ValueError("run_group needs a batchable group")
    exp = build(cells[0][1], device)
    results = {}
    for run_id, spec in cells:
        if verbose:
            print(f"  [group x{len(cells)}] seed {spec.seed}")
        results[run_id] = dataclasses.replace(exp, spec=spec).run(
            log_every=log_every, warmup=warmup, verbose=verbose)
    stats = {"group_size": len(cells), "steps": exp.spec.steps,
             "step_compiles": 0}
    return results, stats
