"""Declarative experiment API (port of ``repro.api``).

    from repro_torch.api import RunSpec, run
    result = run(RunSpec(compressor="randk", agg_mode="pallas",
                         compressor_kwargs={"ratio": 0.1}, steps=300))

``run`` takes the card by default; ``run(spec, device="cpu")`` runs the
plain PyTorch path.
"""
from repro_torch.api.spec import RunSpec  # noqa: F401
from repro_torch.api.runner import (  # noqa: F401
    Experiment, RunResult, build, resolve_device, run,
)
