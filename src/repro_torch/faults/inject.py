"""Message-site fault injection, deterministic and replayable (port of
``repro/faults/inject.py``).

Every mask here is a pure function of ``(plan, key)``, where ``key`` is
the engine's per-round attack key: ``fault_key`` folds the plan seed and
the FaultSpec's index into it, and the draws go through
``repro_torch.random``, bit for bit the reference's. All branching on the
plan is Python-level (the plan is static config), so a run without a plan
runs no op of this module.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.core import tree_utils as tu
from repro_torch.faults.plan import (MESSAGE_FAULTS, TENSOR_FAULTS,
                                     TENSOR_FILL, WIRE_FAULTS, FaultPlan)

_SALT = 0xFA17  # folds the fault stream away from the attack stream


def fault_key(plan: FaultPlan, key, index: int):
    """The key of FaultSpec ``index``: attack key, plan seed, index."""
    k = R.fold_in(key, _SALT + plan.seed % (1 << 20))
    return R.fold_in(k, index)


def _eligible(spec, n: int):
    """Static (n,) eligibility mask from the spec's worker list."""
    if not spec.workers:
        return np.ones((n,), bool)
    m = np.zeros((n,), bool)
    m[[w for w in spec.workers if w < n]] = True
    return m


def _spec_mask(plan, spec, index, key, n):
    """(n,) bool: does ``spec`` hit worker i this round?"""
    elig = torch.as_tensor(_eligible(spec, n), device=key.device)
    if spec.prob >= 1.0:
        return elig
    if spec.prob <= 0.0:
        return torch.zeros(n, dtype=torch.bool, device=key.device)
    return R.bernoulli(fault_key(plan, key, index), spec.prob, (n,)) & elig


def fault_masks(plan: FaultPlan, key, n: int, kinds=MESSAGE_FAULTS):
    """Per-kind (n,) hit masks for this round, OR-ed across same-kind
    specs. Only kinds with at least one spec appear in the dict."""
    masks = {}
    for i, spec in enumerate(plan.faults):
        if spec.kind not in kinds:
            continue
        m = _spec_mask(plan, spec, i, key, n)
        masks[spec.kind] = masks[spec.kind] | m if spec.kind in masks else m
    return masks


def injected_mask(plan: FaultPlan, key, n: int, kinds=MESSAGE_FAULTS):
    """(n,) bool: any fault of ``kinds`` hit worker i this round."""
    out = torch.zeros(n, dtype=torch.bool, device=key.device)
    for m in fault_masks(plan, key, n, kinds).values():
        out = out | m
    return out


def _fill_rows(a, mask, value):
    m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
    return torch.where(m, torch.tensor(value, dtype=a.dtype,
                                       device=a.device), a)


def inject_candidates(plan: FaultPlan, key, cand: dict) -> dict:
    """Apply the plan's tensor faults to a dense stacked candidate tree.
    Later registry kinds overwrite earlier ones on overlapping workers."""
    masks = fault_masks(plan, key, tu.leaves(cand)[0].shape[0],
                        TENSOR_FAULTS)
    for kind in TENSOR_FAULTS:
        if kind in masks:
            cand = tu.tree_map(
                lambda a: _fill_rows(a, masks[kind], TENSOR_FILL[kind]),
                cand)
    return cand


_CARRIER = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _flip_bits(arr, key):
    """XOR every element with random bits of its own width through the
    same-width integer carrier (float32 and int32 take 32 bits, bfloat16
    16, the int8 levels and signs 8). ``jax.random.bits`` of a uint8 or
    uint16 carrier is the low 8 or 16 bits of the 32-bit draw, so one
    ``random_bits`` serves every width."""
    width = 8 * arr.element_size()
    if arr.element_size() not in _CARRIER:
        raise ValueError(f"no bit-flip carrier for {arr.dtype}")
    carrier = _CARRIER[arr.element_size()]
    top = 1 << width
    bits = arr.view(carrier).to(torch.int64) & (top - 1)
    flipped = bits ^ (R.random_bits(key, tuple(arr.shape)) & (top - 1))
    flipped = torch.where(flipped >= top >> 1, flipped - top, flipped)
    return flipped.to(carrier).view(arr.dtype)


def inject_wire(plan: FaultPlan, key, wc):
    """Apply the plan's message faults to a ``WireCandidates``:

    * ``corrupt_wire`` — random bit flips XORed into every payload array
      of the hit workers' rows (floats garble to arbitrary bit patterns,
      sparse indices to arbitrary int32s, which the guard rejects when out
      of range);
    * tensor kinds — the hit workers' float payload arrays take the
      kind's fill value (NaN / inf / 0).
    """
    masks = fault_masks(plan, key, wc.n, MESSAGE_FAULTS)
    if not masks:
        return wc
    new_payloads = []
    for j, payload in enumerate(wc.payloads):
        out = dict(payload)
        for kind in TENSOR_FAULTS:
            if kind not in masks:
                continue
            for name, arr in out.items():
                if arr.is_floating_point():
                    out[name] = _fill_rows(arr, masks[kind],
                                           TENSOR_FILL[kind])
        for kind in WIRE_FAULTS:
            if kind not in masks:
                continue
            for name, arr in out.items():
                k = R.fold_in(fault_key(plan, key, _SALT + j),
                              zlib.crc32(name.encode()) % (1 << 20))
                mm = masks[kind].reshape((-1,) + (1,) * (arr.dim() - 1))
                out[name] = torch.where(mm, _flip_bits(arr, k), arr)
        new_payloads.append(out)
    return dataclasses.replace(wc, payloads=tuple(new_payloads))
