"""Detection-quality metrics against the ground-truth byzantine mask
(a copy of ``repro/obs/detect.py``: numpy only).

The paper-science observable behind Table 2: a robust rule "works" when the
byzantine rows end up with (near-)zero effective weight in the aggregate.
``RoundTrace.influence`` records exactly that weight, so detection quality
is a pure host-side readout:

* a worker counts as FILTERED when its influence falls below ``frac`` of
  the uniform share 1/n (default: half the uniform share);
* precision / recall score the filtered set against ``byz_mask``;
* ``byz_leakage`` is the fraction of total (positive) influence mass held
  by byzantine rows — the quantity that actually perturbs the aggregate,
  and the one ALIE-style attacks are designed to keep high.

Works on a ``to_host`` dict, a history record that embeds the trace
fields, or a RoundTrace whose fields are host arrays.
"""
from __future__ import annotations

import numpy as np


def _field(trace, name):
    if isinstance(trace, dict):
        return trace.get(name)
    return getattr(trace, name, None)


def filtered_mask(trace, frac: float = 0.5) -> np.ndarray:
    """(n,) bool: workers whose influence is below ``frac``·(1/n)."""
    infl = np.asarray(_field(trace, "influence"), np.float64)
    return infl < frac / infl.shape[0]


def detection_metrics(trace, frac: float = 0.5) -> dict:
    """Precision/recall of the filtered-worker set vs the ground-truth
    byzantine mask, plus the byzantine influence-leakage fraction.

    Empty-denominator convention: with nothing filtered precision is 1.0
    (no false accusations), with no byzantines recall is 1.0.
    """
    infl = np.asarray(_field(trace, "influence"), np.float64)
    byz = np.asarray(_field(trace, "byz_mask"), bool)
    filt = filtered_mask(trace, frac)
    tp = int((filt & byz).sum())
    fp = int((filt & ~byz).sum())
    fn = int((~filt & byz).sum())
    pos = np.clip(infl, 0.0, None)
    tot = pos.sum()
    return {
        "n_filtered": int(filt.sum()),
        "precision": tp / (tp + fp) if tp + fp else 1.0,
        "recall": tp / (tp + fn) if tp + fn else 1.0,
        "byz_leakage": float(pos[byz].sum() / tot) if tot > 0 else 0.0,
    }


def fault_metrics(trace) -> dict:
    """Precision/recall of the fail-closed guard's rejections against the
    chaos layer's injected ground truth (``repro_torch.faults``).

    Detection is ``~guard_valid`` (rows the guard zero-weighted); truth is
    ``fault_mask`` (rows the FaultPlan actually hit). {} when the trace
    carries no fault telemetry (no plan or guard off). A Byzantine row the
    attack overwrote with a finite value is excluded from the truth set —
    the guard is *specified* not to catch statistical adversaries, so
    counting it as a miss would score the spec, not the guard.
    """
    fm = _field(trace, "fault_mask")
    gv = _field(trace, "guard_valid")
    if fm is None or gv is None:
        return {}
    truth = np.asarray(fm, bool)
    det = ~np.asarray(gv, bool)
    byz = _field(trace, "byz_mask")
    if byz is not None:
        truth = truth & ~(np.asarray(byz, bool) & ~det)
    tp = int((det & truth).sum())
    fp = int((det & ~truth).sum())
    fn = int((~det & truth).sum())
    return {
        "n_injected": int(truth.sum()),
        "n_rejected": int(det.sum()),
        "fault_precision": tp / (tp + fp) if tp + fp else 1.0,
        "fault_recall": tp / (tp + fn) if tp + fn else 1.0,
    }


def summarize(traces, frac: float = 0.5) -> dict:
    """Mean detection metrics over a run's logged traces (host dicts or
    RoundTrace objects); {} when there is nothing to summarize."""
    mets = [detection_metrics(t, frac) for t in traces
            if _field(t, "influence") is not None]
    if not mets:
        return {}
    out = {k: float(np.mean([m[k] for m in mets]))
           for k in ("precision", "recall", "byz_leakage")}
    out["n_filtered_mean"] = float(np.mean([m["n_filtered"] for m in mets]))
    out["rounds"] = len(mets)
    fmets = [fm for fm in (fault_metrics(t) for t in traces) if fm]
    if fmets:
        for k in ("fault_precision", "fault_recall"):
            out[k] = float(np.mean([m[k] for m in fmets]))
        out["n_injected_mean"] = float(
            np.mean([m["n_injected"] for m in fmets]))
    return out
