"""Carry values made by the reference package into the port.

The reference's arrays arrive as numpy arrays (``np.asarray`` of a JAX
array; bfloat16 as ``ml_dtypes.bfloat16``); these functions turn them
into the port's tensors on a given device, keeping dtypes. A nested
tree (the reference's LM parameters: dicts, with tuples of per-pattern
groups) becomes the port's flat dict keyed by the ``/``-joined path,
tuple indices as numbers (``groups/0/mixer/wq``). ``LogRegData
.from_numpy`` does the same for a dataset.
"""
from __future__ import annotations

import numpy as np
import torch


# estimator state keys holding a parameter tree
_PARAM_TREES = ("prev_params", "snapshot")


def flatten_tree(tree, prefix: str = "") -> dict:
    """A nested dict / tuple tree -> {"a/0/b": leaf}."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for name, sub in items:
        out.update(flatten_tree(sub, f"{prefix}/{name}" if prefix else name))
    return out


def leaf_from_numpy(value, device="cpu") -> torch.Tensor:
    """An array -> a tensor of its dtype (bfloat16 through its bits)."""
    arr = np.array(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def tree_from_numpy(tree, device="cpu") -> dict:
    """A tree of arrays (params, g, a batch, an anchor; flat or nested)
    -> the port's flat dict of tensors."""
    return {k: leaf_from_numpy(v, device)
            for k, v in flatten_tree(tree).items()}


def _opt_state_from_numpy(opt, device):
    """An optimizer state: None (the plain step), {} (SGD without
    momentum), or {"m": tree[, "v": tree, "t": count]}."""
    if opt is None:
        return None
    return {k: (tree_from_numpy(v, device) if isinstance(v, (dict, tuple))
                else leaf_from_numpy(v, device)) for k, v in opt.items()}


def state_from_numpy(state: dict, device="cpu") -> dict:
    """An engine state {"params", "g", "step", "opt_state", ...} -> the
    port's state, with the optimizer's state and the estimators' state:
    per-worker trees (``worker_*``, e.g. Byz-EF21's ``worker_g``),
    parameter trees (MVR's ``prev_params``, SVRG's ``snapshot``) and
    DIANA's 0-d ``alpha``."""
    trees = sorted(k for k in state if k.startswith("worker_")
                   or k in _PARAM_TREES)
    extra = sorted(set(state) - {"params", "g", "step", "opt_state",
                                 "alpha", *trees})
    if extra:
        raise NotImplementedError(f"estimator state {extra} is not ported")
    out = {"params": tree_from_numpy(state["params"], device),
           "g": tree_from_numpy(state["g"], device),
           **{k: tree_from_numpy(state[k], device) for k in trees},
           "opt_state": _opt_state_from_numpy(state.get("opt_state"),
                                              device),
           "step": int(state["step"])}
    if "alpha" in state:
        out["alpha"] = leaf_from_numpy(state["alpha"], device)
    return out


def key_from_numpy(key, device="cpu") -> torch.Tensor:
    """A JAX key, a (..., 2) uint32 array, -> the port's int64 key."""
    arr = np.asarray(key)
    if arr.dtype != np.uint32 or arr.shape[-1:] != (2,):
        raise ValueError(f"expected a (..., 2) uint32 key, got {arr.dtype} "
                         f"{arr.shape}")
    return torch.as_tensor(arr.astype(np.int64), device=device)
