"""Checkpointing: a state tree <-> ``.npz`` with a structure manifest
(port of ``repro/checkpoint/checkpoint.py``).

The file format is the reference's, so a checkpoint written by either
package loads in the other: leaf ``leaf_{i:05d}`` holds the i-th leaf in
the order of the sorted ``/``-joined path keys, and ``<path>.json`` holds
``{"step": ..., "leaves": {key: {"name", "dtype", "shape"}}}``. Dtypes
numpy cannot store (bfloat16, the float8 formats) are stored as raw
unsigned-integer views under their own dtype name.

A state is nested dicts (lists and tuples index as ``[i]``) of tensors;
``None`` is an empty subtree and writes nothing, as an empty pytree does
in the reference. A flat model dict's ``/``-joined key is its path in
the reference's nested tree, whose tuple indices are its number parts:
``params`` / ``groups/0/mixer/wq`` is written as
``params/groups/[0]/mixer/wq``, the reference's key. A Python ``int`` leaf (the engine's host ``step``) is
written as the reference's 0-d int32 and read back as an ``int``.
Tensors are copied to the host, never aliased.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

# torch dtype -> (the reference's dtype name, the integer view torch
# reinterprets it as, that view's numpy dtype, the stored numpy dtype)
_EXOTIC = {
    torch.bfloat16: ("bfloat16", torch.int16, np.int16, np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8, np.uint8)}
_EXOTIC_BY_NAME = {v[0]: (dt,) + v[1:] for dt, v in _EXOTIC.items()}


def _key_path(key) -> tuple:
    """A dict key's parts in the reference's tree: a ``/``-joined flat
    key splits, its number parts being tuple indices."""
    return tuple(f"[{p}]" if p.isdigit() else p
                 for p in str(key).split("/"))


def _flatten_with_paths(tree, prefix=()) -> dict:
    """{"a/b/[0]": leaf} in the reference's tree order (dict keys
    sorted)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(_key_path(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [((f"[{i}]",), v) for i, v in enumerate(tree)]
    else:
        return {"/".join(prefix): tree}
    out = {}
    for path, sub in items:
        out.update(_flatten_with_paths(sub, prefix + path))
    return out


def _to_numpy(leaf):
    """A leaf as a host array and the dtype name the manifest records."""
    if isinstance(leaf, bool) or not isinstance(
            leaf, (int, torch.Tensor, np.ndarray)):
        raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)}")
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    if isinstance(leaf, np.ndarray):
        return leaf.copy(), str(leaf.dtype)
    t = leaf.detach().cpu()
    if t.dtype in _EXOTIC:
        name, view, _, stored = _EXOTIC[t.dtype]
        return t.contiguous().view(view).numpy().view(stored).copy(), name
    arr = t.numpy().copy()
    return arr, str(arr.dtype)


def save_checkpoint(path: str, state, step: int | None = None):
    """Write ``<path>.npz`` and ``<path>.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten_with_paths(state)
    arrays = {}
    manifest = {"step": int(step) if step is not None else None,
                "leaves": {}}
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        name = f"leaf_{i:05d}"
        arr, dtype_name = _to_numpy(leaf)
        arrays[name] = arr
        manifest["leaves"][key] = {"name": name, "dtype": dtype_name,
                                   "shape": list(arr.shape)}
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def _restore(raw: np.ndarray, dtype_name: str, like, device):
    if isinstance(like, int):
        if raw.shape != ():
            raise ValueError(f"expected a 0-d leaf, got shape {raw.shape}")
        return int(raw)
    if dtype_name in _EXOTIC_BY_NAME:
        dt, _, np_view, _ = _EXOTIC_BY_NAME[dtype_name]
        t = torch.from_numpy(np.array(raw).view(np_view)).view(dt)
    else:
        t = torch.from_numpy(np.array(raw))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for "
                         f"a template leaf of shape {tuple(like.shape)}")
    return t.to(like.device if device is None else device)


def _rebuild(like, restored: dict, prefix=()):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, restored, prefix + _key_path(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, restored, prefix + (f"[{i}]",))
                          for i, v in enumerate(like))
    return restored["/".join(prefix)]


def load_checkpoint(path: str, like, device=None):
    """Restore into the structure of ``like`` (a template tree); each
    leaf goes on the template leaf's device, or on ``device`` when given.
    Returns ``(tree, step)``."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    restored = {}
    with np.load(path + ".npz") as data:
        for key, leaf in _flatten_with_paths(like).items():
            entry = manifest["leaves"][key]
            restored[key] = _restore(data[entry["name"]], entry["dtype"],
                                     leaf, device)
    return _rebuild(like, restored), manifest["step"]
