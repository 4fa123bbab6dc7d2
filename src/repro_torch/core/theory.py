"""Theory helpers (port of ``repro/core/theory.py``). This slice needs only
the δ bookkeeping that validates configurations; step sizes and the
communication formulas are not ported yet (ROADMAP queue 1, item 5)."""
from __future__ import annotations


def delta_over_active_set(n_active: int, n_byz_active: int, *,
                          bucket_size: int = 1) -> float:
    """Effective byzantine fraction δ over the cohort the aggregator sees;
    bucketing with size s multiplies it by s. An empty cohort counts as
    fully adversarial."""
    n_active = int(n_active)
    if n_active <= 0:
        return 1.0
    b = min(int(n_byz_active), n_active)
    return b * max(int(bucket_size), 1) / n_active
