"""Carry values made by the reference package into the port.

The reference's arrays arrive as numpy arrays (``np.asarray`` of a JAX
array); these functions turn them into the port's tensors on a given
device, keeping dtypes. ``LogRegData.from_numpy`` does the same for a
dataset.
"""
from __future__ import annotations

import numpy as np
import torch


# estimator state keys holding a parameter tree
_PARAM_TREES = ("prev_params", "snapshot")


def tree_from_numpy(tree: dict, device="cpu") -> dict:
    """A dict of arrays (params, g, a batch, an anchor) -> dict of
    tensors."""
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in tree.items()}


def state_from_numpy(state: dict, device="cpu") -> dict:
    """An engine state {"params", "g", "step", ...} -> the port's state,
    with the estimators' state: per-worker trees (``worker_*``, e.g.
    Byz-EF21's ``worker_g``), parameter trees (MVR's ``prev_params``,
    SVRG's ``snapshot``) and DIANA's 0-d ``alpha``. Optimizer state is not
    ported, so it must be None."""
    if state.get("opt_state") is not None:
        raise NotImplementedError(
            "optimizer state is not ported yet (ROADMAP queue 1, item 12)")
    trees = sorted(k for k in state if k.startswith("worker_")
                   or k in _PARAM_TREES)
    extra = sorted(set(state) - {"params", "g", "step", "opt_state",
                                 "alpha", *trees})
    if extra:
        raise NotImplementedError(f"estimator state {extra} is not ported")
    out = {"params": tree_from_numpy(state["params"], device),
           "g": tree_from_numpy(state["g"], device),
           **{k: tree_from_numpy(state[k], device) for k in trees},
           "opt_state": None, "step": int(state["step"])}
    if "alpha" in state:
        out["alpha"] = torch.as_tensor(np.array(state["alpha"]),
                                       device=device)
    return out


def key_from_numpy(key, device="cpu") -> torch.Tensor:
    """A JAX key, a (..., 2) uint32 array, -> the port's int64 key."""
    arr = np.asarray(key)
    if arr.dtype != np.uint32 or arr.shape[-1:] != (2,):
        raise ValueError(f"expected a (..., 2) uint32 key, got {arr.dtype} "
                         f"{arr.shape}")
    return torch.as_tensor(arr.astype(np.int64), device=device)
