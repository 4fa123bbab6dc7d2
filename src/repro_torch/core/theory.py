"""Theory helpers (port of ``repro/core/theory.py``): the δ bookkeeping
that validates configurations, and the communication count of a round.
The step sizes and rates are not ported yet (ROADMAP queue 1, item 6b)."""
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


# method -> wire family: "vr_switch" is MARINA's coin between full 32·d
# uploads and Q(·) rounds; "compressed" one Q(·) upload every round;
# "contractive_ef" one C(·) upload every round (error feedback, no full
# rounds); "dense" 32·d every round
BITS_FAMILY = {
    "marina": "vr_switch",
    "csgd": "compressed",
    "diana": "compressed",
    "cmfilter": "compressed",
    "byz_ef21": "contractive_ef",
    "sgd": "dense",
    "sgdm": "dense",
    "mvr": "dense",
    "svrg": "dense",
    "saga": "dense",
}


def comm_bits_per_round(method: str, compressor, d: int, *,
                        p: float = 1.0, dims=None,
                        participation: float = 1.0) -> float:
    """Expected uploaded bits per configured worker per round.

    ``dims`` (per-leaf flat sizes) switches to the per-leaf accounting,
    Σ_l bits_Q(d_l), what ``wire.pack_candidates`` puts on the wire;
    without it one vector of d coordinates. ``participation``, the sampled
    fraction of the workers, scales the expectation: a worker left out
    uploads nothing that round (the runner bills n_active / n_workers of
    each round likewise)."""
    if method not in BITS_FAMILY:
        raise KeyError(
            f"unknown method {method!r}; known: {sorted(BITS_FAMILY)}")
    family = BITS_FAMILY[method]
    if dims is not None:
        d = int(sum(int(x) for x in dims))
    dense = 32.0 * d
    if family == "dense":
        return participation * dense
    bits_q = (float(compressor.tree_bits(dims)) if dims is not None
              else float(compressor.bits_per_vector(d)))
    if family == "vr_switch":
        return participation * (p * dense + (1.0 - p) * bits_q)
    return participation * bits_q      # compressed | contractive_ef
