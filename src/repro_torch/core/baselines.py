"""Baseline methods the paper compares against (port of
``repro/core/baselines.py``, Section 3 / Appendix B).

* SGD       — Parallel-SGD with plain averaging.
* BR-SGDm   — robust aggregation of worker momenta.
* CSGD      — compressed SGD; with a robust aggregator BR-CSGD.
* BR-DIANA  — DIANA shifts + robust aggregation.
* BR-MVR    — STORM momentum variance reduction + robust aggregation.
* Byrd-SVRG — SVRG estimator + geometric median (App. B.4).

Each maker plugs the matching estimator of ``core/estimators.py`` into
the shared engine and keeps the reference's ``(init, step)`` signatures;
new code uses ``engine.make_method`` directly. Byrd-SAGA keeps its own
per-sample-gradient-table interface over the same attack and aggregation.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.func import vmap

from repro_torch import random as R
from repro_torch.core import tree_utils as tu
from repro_torch.core.engine import make_method, message_phase
from repro_torch.core.estimators import saga_update


def _sgd_update(params, g, lr):
    return tu.tree_map(lambda x, gg: (x.float() - lr * gg.float())
                       .to(x.dtype), params, g)


def make_sgd_step(cfg, loss_fn, corrupt_fn=None, momentum: float = 0.0):
    """momentum=0: Parallel-SGD; momentum>0: BR-SGDm."""
    m = make_method("sgdm" if momentum > 0.0 else "sgd", cfg, loss_fn,
                    corrupt_fn, momentum=momentum)

    def init(params):
        return m.init(params, None, None)

    return init, m.step


def make_csgd_step(cfg, loss_fn, corrupt_fn=None):
    m = make_method("csgd", cfg, loss_fn, corrupt_fn)

    def init(params):
        return m.init(params, None, None)

    return init, m.step


def make_diana_step(cfg, loss_fn, corrupt_fn=None,
                    alpha: Optional[float] = None):
    """DIANA; alpha defaults to 1/(1+ω(d_hint))."""
    m = make_method("diana", cfg, loss_fn, corrupt_fn, alpha=alpha)

    def init(params, d_hint: int = 1):
        m.estimator.d_hint = int(d_hint)
        return m.init(params, None, None)

    return init, m.step


def make_br_mvr_step(cfg, loss_fn, corrupt_fn=None, alpha: float = 0.1):
    """BR-MVR: v_i^k = g_i(x^k) + (1-α)(v_i^{k-1} - g_i(x^{k-1}))."""
    m = make_method("mvr", cfg, loss_fn, corrupt_fn, alpha=alpha)

    def init(params, batch, key):
        return m.init(params, batch, key)

    return init, m.step


def make_byrd_svrg_step(cfg, loss_fn, corrupt_fn=None):
    """Loopless SVRG, aggregated by the configured rule (RFA in the
    paper)."""
    m = make_method("svrg", cfg, loss_fn, corrupt_fn)
    return m.init, m.step


def make_byrd_saga_step(cfg, grad_sample_fn, n_samples, params_template,
                        corrupt_labels=None):
    """Byrd-SAGA: per-worker SAGA tables (O(m·d) memory) + the configured
    aggregation. ``grad_sample_fn(params, x_j, y_j)`` is one sample's
    gradient tree. ``step(state, data, idx, key)`` takes idx (n, b) table
    slots and data {"x": (n, m, d), "y": (n, m)}."""
    n = cfg.n_workers
    m = n_samples

    def step(state, data, idx, key):
        k_attack, k_agg = R.split(key)
        params = state["params"]
        xw, yw = data["x"], data["y"]
        if corrupt_labels is not None and cfg.attack.flips_labels \
                and cfg.n_byz:
            yw = corrupt_labels(yw, cfg.byz_mask(yw.device))
        b = idx.shape[1]
        xs = torch.gather(xw, 1, idx[..., None].expand(n, b, xw.shape[-1]))
        ys = torch.gather(yw, 1, idx)
        g_new = vmap(grad_sample_fn, in_dims=(None, 0, 0))(
            params, xs.reshape(n * b, -1), ys.reshape(n * b))
        v, tables, means = {}, {}, {}
        for k in sorted(state["tables"]):
            t = state["tables"][k]
            gn = g_new[k].float().reshape((n, b) + tuple(t.shape[2:]))
            v[k], tables[k], means[k] = saga_update(
                t, state["table_means"][k], gn, idx)
        g = message_phase(cfg, k_attack, k_agg, v)
        return ({"params": _sgd_update(params, g, cfg.lr), "tables": tables,
                 "table_means": means, "step": state["step"] + 1},
                {"g_norm": torch.sqrt(tu.tree_norm_sq(g))})

    def init(params, data):
        return {"params": params,
                "tables": tu.tree_map(
                    lambda p: torch.zeros((n, m) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params),
                "table_means": tu.tree_broadcast_leading(
                    tu.tree_map(lambda p: torch.zeros_like(
                        p, dtype=torch.float32), params), n),
                "step": 0}

    return init, step
