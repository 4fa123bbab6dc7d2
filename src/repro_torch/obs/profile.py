"""Profiling: a ``torch.profiler`` trace context and one range a round
(port of ``repro/obs/profile.py``).

``profile_trace(dir)`` wraps a run in ``torch.profiler.profile`` (CPU
activity, and CUDA activity where a card is present) and writes a Chrome
trace (``trace_*.json``, loadable in Perfetto or ``chrome://tracing``)
into ``dir`` on exit; without ``dir`` it is a null context, so call sites
can wrap unconditionally. ``enable_step_markers()`` is the twin of the
reference's XLA step-marker idiom: once on, ``api.run`` wraps each round
in one ``torch.profiler.record_function("round")`` range, so the trace
shows round boundaries. There are no finer ranges, as in the reference.
``add_cli_args`` gives the launch CLIs ``--metrics-out-jsonl`` and
``--profile-dir``.
"""
from __future__ import annotations

import contextlib
import os
import time

ROUND_RANGE = "round"
_STEP_MARKERS = [False]


def enable_step_markers(enabled: bool = True) -> None:
    """Have ``api.run`` mark every round with a ``ROUND_RANGE`` range
    (idempotent); ``enabled=False`` turns the ranges off again."""
    _STEP_MARKERS[0] = enabled


def round_range():
    """The range of one round when step markers are on; a null context
    otherwise."""
    if not _STEP_MARKERS[0]:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(ROUND_RANGE)


@contextlib.contextmanager
def profile_trace(profile_dir=None):
    """``torch.profiler.profile`` when ``profile_dir`` is set, its Chrome
    trace written there on exit; a null context otherwise. Yields the
    profiler (or None)."""
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(profile_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    stamp = time.strftime("%Y%m%d_%H%M%S")
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{stamp}_{os.getpid()}.json"))



def add_cli_args(ap) -> None:
    """The shared observability CLI surface of the launch CLIs."""
    ap.add_argument("--metrics-out-jsonl", metavar="PATH",
                    help="append metric events (rounds, traces, spans) as "
                         "one JSON line each — the obs.sink stream")
    ap.add_argument("--profile-dir", metavar="DIR",
                    help="write a torch.profiler Chrome trace here, with "
                         "one 'round' range a round")
