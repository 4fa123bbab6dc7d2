"""Declarative experiment API (port of ``repro.api``).

    from repro_torch.api import RunSpec, run
    result = run(RunSpec(compressor="randk", agg_mode="pallas",
                         compressor_kwargs={"ratio": 0.1}, steps=300))

``run`` takes the card by default; ``run(spec, device="cpu")`` runs the
plain PyTorch path. ``Sweep`` expands grids, ``run_sweep`` runs them
through ``repro_torch.exec``, and ``registry`` enumerates every pluggable
component from one source of truth.
"""
from repro_torch.api.registry import (  # noqa: F401
    check, components, describe, kinds, resolve,
)
from repro_torch.api.spec import RunSpec, resolve_agg_mode  # noqa: F401
from repro_torch.api.runner import (  # noqa: F401
    Experiment, RunResult, build, resolve_device, run,
)
from repro_torch.api.sweep import Sweep, run_sweep  # noqa: F401
