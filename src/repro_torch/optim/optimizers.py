"""Optimizers over flat parameter dicts (port of
``repro/optim/optimizers.py``).

Each optimizer is a frozen dataclass with ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state)``. The engine
feeds the robustly aggregated estimator g^k in place of the gradients,
so Byz-VR-MARINA composes with any of them (the paper's Alg. 1 is the
plain step of ``engine.param_update``). The math is float32, as in the
reference, and each new parameter is cast back to its leaf's dtype.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import tree_utils as tu


def _cast_like(new: dict, ref: dict) -> dict:
    return tu.tree_map(lambda n, r: n.to(r.dtype), new, ref)


def _zeros_f32(params: dict) -> dict:
    return tu.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                       params)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 0.05
    momentum: float = 0.0
    weight_decay: float = 0.0

    def init(self, params):
        if self.momentum == 0.0:
            return {}
        return {"m": _zeros_f32(params)}

    def update(self, grads, state, params):
        if self.weight_decay:
            grads = tu.tree_map(
                lambda g, p: g + self.weight_decay * p.to(g.dtype),
                grads, params)
        if self.momentum == 0.0:
            new = tu.tree_map(lambda p, g: p.float() - self.lr * g.float(),
                              params, grads)
            return _cast_like(new, params), state
        m = tu.tree_map(lambda mm, g: self.momentum * mm + g.float(),
                        state["m"], grads)
        new = tu.tree_map(lambda p, mm: p.float() - self.lr * mm, params, m)
        return _cast_like(new, params), {"m": m}


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0     # decoupled (AdamW)

    def init(self, params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=tu.leaves(params)[0].device)}

    def update(self, grads, state, params):
        t = state["t"] + 1
        m = tu.tree_map(lambda mm, g: self.b1 * mm
                        + (1 - self.b1) * g.float(), state["m"], grads)
        v = tu.tree_map(lambda vv, g: self.b2 * vv
                        + (1 - self.b2) * g.float().square(),
                        state["v"], grads)
        tf = t.float()
        bc1 = 1 - torch.pow(torch.tensor(self.b1, device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, device=tf.device), tf)

        def upd(p, mm, vv):
            step = self.lr * (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            out = p.float() - step
            if self.weight_decay:
                out = out - self.lr * self.weight_decay * p.float()
            return out

        new = tu.tree_map(upd, params, m, v)
        return _cast_like(new, params), {"m": m, "v": v, "t": t}


OPTIMIZERS = {"sgd": SGD, "adam": Adam}


def get_optimizer(name: str, **kw):
    if name not in OPTIMIZERS:
        raise KeyError(
            f"unknown optimizer {name!r}; known: {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](**kw)
