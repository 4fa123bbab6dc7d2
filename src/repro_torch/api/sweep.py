"""Cartesian grid expansion over ``RunSpec`` fields (port of
``repro/api/sweep.py``).

    sweep = Sweep(base=RunSpec(steps=500),
                  grid={"aggregator": ("mean", "cm", "rfa"),
                        "attack": ("NA", "BF", "ALIE"),
                        "compressor_kwargs.ratio": (0.1, 1.0)})
    for run_id, spec in sweep.expand():
        result = spec.run()

Grid keys are spec field names; dotted keys reach into the per-component
kwargs dicts (``spec.replace`` semantics). Run ids are the reference's
for the same grid, and every expanded spec is validated at construction,
so an invalid cell fails before any training starts.
"""
from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Mapping, Sequence

from repro_torch.api.spec import RunSpec


def _fmt(value) -> str:
    s = str(value)
    return re.sub(r"[^A-Za-z0-9_.+-]+", "-", s) or "none"


@dataclasses.dataclass(frozen=True)
class Sweep:
    """``base`` spec + ``grid`` of field -> candidate values (insertion
    order of ``grid`` fixes both the expansion order and the run-id field
    order, so ids are stable across runs)."""
    base: RunSpec
    grid: Mapping[str, Sequence]

    def __post_init__(self):
        for key in self.grid:
            field = key.split(".", 1)[0]
            if field not in {f.name for f in dataclasses.fields(RunSpec)}:
                raise ValueError(
                    f"sweep grid key {key!r}: {field!r} is not a RunSpec "
                    "field")

    def __len__(self) -> int:
        n = 1
        for vals in self.grid.values():
            n *= len(vals)
        return n

    def run_id(self, overrides: Mapping) -> str:
        return "__".join(f"{k}={_fmt(v)}" for k, v in overrides.items())

    def expand(self):
        """Yield ``(run_id, spec)`` per grid cell, row-major in grid order."""
        names = list(self.grid)
        for combo in itertools.product(*(self.grid[n] for n in names)):
            overrides = dict(zip(names, combo))
            yield self.run_id(overrides), self.base.replace(**overrides)


def run_sweep(sweep: Sweep, *, out_dir: str = None, resume: bool = False,
              batch="auto", pool=None, ledger_path: str = None,
              summary_out: str = None, cell_hook=None, **run_kw):
    """Run every cell through the execution engine (``repro_torch.exec``).

    Returns a ``SweepRun``: a mapping ``{run_id: result}`` (live
    ``RunResult``s for cells run here, loaded ``CompletedCell``s for
    resumed or subprocess ones) with ``.artifacts`` / ``.failures`` /
    ``.stats``. Same-signature multi-seed cells run as one group over one
    ``Experiment`` (``batch=False`` opts out); with ``out_dir``, each cell
    writes ``<run_id>.json`` and the crash-safe ledger (``ledger.jsonl``)
    makes ``resume=True`` skip completed cells. ``pool=exec.WorkerPool(
    ...)`` shards the other cells over pinned worker subprocesses;
    ``summary_out`` writes the mean±std-over-seeds summary table
    (``exec.aggregate``). ``device`` among ``run_kw`` sets every cell's
    device, in process and in the workers. A failing cell is isolated and
    recorded, not raised — check ``.failures``.
    """
    from repro_torch import exec as xc
    srun = xc.run_cells(list(sweep.expand()), out_dir=out_dir,
                        ledger_path=ledger_path, resume=resume, batch=batch,
                        pool=pool, run_kw=run_kw, cell_hook=cell_hook)
    if summary_out:
        xc.write_summary(summary_out, xc.summarize(srun.artifacts))
    return srun
