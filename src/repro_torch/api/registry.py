"""One namespaced component registry (port of ``repro/api/registry.py``).

The per-module registries of the port stay the owners of their entries
(estimators, attacks, aggregation rules, compressors, backends); this
module only references them, so CLIs, docs and ``RunSpec`` validation
enumerate from one source of truth:

    components("method")            -> ("byz_ef21", "cmfilter", ..., "svrg")
    describe("attack", "ALIE")      -> one-line summary
    resolve("compressor", "randk", ratio=0.1) -> Compressor instance
    check("aggregator", "krun")     -> ValueError: ... did you mean 'krum'?

The names and descriptions are the reference's. ``arch`` lists all ten
registered configs; ``check`` and ``resolve`` succeed for the dense
attention decoders and raise ``NotImplementedError`` for the configs
whose blocks are not ported yet, naming their ROADMAP item.
"""
from __future__ import annotations

import difflib
from typing import Any, Optional

from repro_torch.core import aggregators as _aggregators
from repro_torch.core import attacks as _attacks
from repro_torch.core import compressors as _compressors
from repro_torch.core.engine import AGG_BACKENDS


_METHOD_DESCRIPTIONS = {
    "marina": "Byz-VR-MARINA (Alg. 1): geometric coin between anchor "
              "full-gradients and compressed SARAH differences",
    "sgd": "Parallel-SGD with (robust) averaging (Zinkevich et al. 2010)",
    "sgdm": "BR-SGDm: worker momenta attacked & aggregated "
            "(Karimireddy et al. 2021/22)",
    "csgd": "compressed SGD; with a robust aggregator = BR-CSGD",
    "diana": "BR-DIANA: worker shifts h_i, uploads Q(g_i - h_i) "
             "(Mishchenko et al. 2019)",
    "mvr": "BR-MVR / STORM momentum variance reduction "
           "(Karimireddy et al. 2021)",
    "svrg": "Byrd-SVRG: loopless SVRG + robust aggregation "
            "(App. B.4, Wu et al. 2020)",
    "byz_ef21": "Byz-EF21: biased contractive compression + per-worker "
                "error feedback (Rammal et al. 2023)",
    "cmfilter": "compressed momentum filtering: worker momenta uploaded as "
                "compressed differences, robustly filtered "
                "(Liu et al. 2024)",
    "saga": "Byrd-SAGA: per-worker per-sample gradient table over the "
            "anchor partition (Wu et al. 2020)",
}

_ATTACK_DESCRIPTIONS = {
    "NA": "no attack (clean training)",
    "LF": "label flipping (data-level; update hook is identity)",
    "BF": "bit flipping: send -honest",
    "ALIE": "A Little Is Enough: mean - z*std (Baruch et al. 2019)",
    "IPM": "inner-product manipulation: -eps*mean (Xie et al. 2020)",
    "RN": "random gaussian noise",
}

_AGGREGATOR_DESCRIPTIONS = {
    "mean": "plain averaging (not robust; the paper's AVG row)",
    "cm": "coordinate-wise median (c=O(d), delta<1/2 with bucketing)",
    "tm": "coordinate-wise trimmed mean",
    "rfa": "geometric median via smoothed Weiszfeld (c=O(1), delta<1/2)",
    "krum": "Krum selection rule (c=O(1), delta<1/4 with bucketing)",
}

_COMPRESSOR_DESCRIPTIONS = {
    "identity": "no compression (32d bits per vector)",
    "randk": "RandK sparsification, omega = d/K - 1 "
             "(block selection above 2^22 units)",
    "topk": "TopK magnitude sparsification (BIASED, contractive "
            "delta=1-K/d; EF21-family methods)",
    "dither": "l2 random dithering / QSGD-style quantization "
              "(Alistarh et al. 2017)",
    "natural": "natural compression: stochastic power-of-two rounding, "
               "omega = 1/8",
    "sign": "sign(x)*||x||_1/d (BIASED; signSGD baselines only)",
    "int8": "blockwise l2-dithering on a real int8 wire (QSGD s=127 per "
            "256-coord block; fused pallas payload)",
    "bf16": "deterministic bfloat16 rounding (BIASED, contractive "
            "delta=2^-16; the trivial kernel wire)",
}

_OPTIMIZER_DESCRIPTIONS = {
    "none": "plain x <- x - lr*g (the paper's Alg. 1 update)",
    "sgd": "SGD with optional momentum / weight decay on top of the "
           "robust estimator",
    "adam": "Adam(W) on top of the robust estimator",
}

_AGG_MODE_DESCRIPTIONS = {
    "gspmd": "paper-faithful jnp over the stacked worker axis "
             "(GSPMD all-gather on a mesh)",
    "all_to_all": "shard_map sharded aggregation: ~2x d_local collective "
                  "bytes, O(n) less memory (coordinate-wise rules only)",
    "sparse_support": "common-randomness RandK: attack + aggregate only the "
                      "shared K-coordinate support (marina)",
    "pallas": "fused one-HBM-sweep kernels serving every rule leaf-wise, "
              "with kernel-fusable attacks injected in the load",
}

_TASK_DESCRIPTIONS = {
    "logreg": "l2-regularized logistic regression on synthetic a9a-like "
              "data (the paper's own experiments)",
    "lm": "synthetic-token LM training on a registered arch config "
          "(framework scale)",
}

TASKS = tuple(sorted(_TASK_DESCRIPTIONS))
# the reference's order: "none" first, then its optimizer registry sorted
OPTIMIZER_CHOICES = ("none", "adam", "sgd")


def _method_names():
    from repro_torch.core.estimators import ESTIMATORS
    return tuple(sorted(ESTIMATORS))


def _resolve_method(name, **kw):
    """Methods are (cfg, loss_fn)-bound; resolve returns the estimator
    factory. Estimator knobs go through ``engine.make_method`` or
    ``RunSpec.method_kwargs``, so none can be dropped silently here."""
    if kw:
        raise TypeError(
            f"resolve('method', {name!r}, ...) takes no kwargs — estimator "
            "knobs go through make_method(...) or RunSpec.method_kwargs; "
            f"got {sorted(kw)}")
    from repro_torch.core.estimators import ESTIMATORS
    return ESTIMATORS[name]


def _resolve_optimizer(name, **kw):
    if name == "none":
        return None
    from repro_torch.optim import get_optimizer
    return get_optimizer(name, **kw)


def _arch_names():
    from repro_torch.configs import list_configs
    return tuple(list_configs())


def _describe_arch(name):
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return f"{cfg.family}: {cfg.citation}"


def _resolve_arch(name, **kw):
    """The ``ArchConfig``; raises ``NotImplementedError`` for a config
    whose blocks are not ported yet."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import check_supported
    cfg = get_config(name)
    check_supported(cfg)
    return cfg


# kind -> (component enumerator, describe fn, resolver)
_KINDS = {
    "method": (_method_names,
               lambda n: _METHOD_DESCRIPTIONS.get(n, ""),
               _resolve_method),
    "attack": (lambda: tuple(sorted(_attacks.REGISTRY)),
               lambda n: _ATTACK_DESCRIPTIONS.get(n, ""),
               lambda n, **kw: _attacks.get_attack(n, **kw)),
    "aggregator": (lambda: tuple(sorted(_aggregators.RULES)),
                   lambda n: _AGGREGATOR_DESCRIPTIONS.get(n, ""),
                   lambda n, **kw: _aggregators.get_aggregator(n, **kw)),
    "compressor": (lambda: tuple(sorted(_compressors.REGISTRY)),
                   lambda n: _COMPRESSOR_DESCRIPTIONS.get(n, ""),
                   lambda n, **kw: _compressors.get_compressor(n, **kw)),
    "optimizer": (lambda: OPTIMIZER_CHOICES,
                  lambda n: _OPTIMIZER_DESCRIPTIONS.get(n, ""),
                  _resolve_optimizer),
    "agg_mode": (lambda: tuple(AGG_BACKENDS),
                 lambda n: _AGG_MODE_DESCRIPTIONS.get(n, ""),
                 lambda n, **kw: n),
    "arch": (_arch_names, _describe_arch, _resolve_arch),
    "task": (lambda: TASKS,
             lambda n: _TASK_DESCRIPTIONS.get(n, ""),
             lambda n, **kw: n),
}


def kinds() -> tuple:
    """All registered component namespaces."""
    return tuple(sorted(_KINDS))


def components(kind: str) -> tuple:
    """Registered names under ``kind``, sorted."""
    _check_kind(kind)
    return _KINDS[kind][0]()


def describe(kind: str, name: Optional[str] = None):
    """One-line summary of ``name``, or {name: summary} for the whole kind."""
    _check_kind(kind)
    if name is None:
        return {n: _KINDS[kind][1](n) for n in components(kind)}
    check(kind, name)
    return _KINDS[kind][1](name)


def check(kind: str, name: str) -> str:
    """Validate ``name`` is registered under ``kind``; raise a did-you-mean
    ValueError otherwise. Returns the name so it composes in expressions."""
    _check_kind(kind)
    known = components(kind)
    if name not in known:
        raise ValueError(_unknown(kind, name, known))
    if kind == "arch":
        _resolve_arch(name)
    return name


def resolve(kind: str, name: str, **kwargs) -> Any:
    """Build the named component (e.g. a Compressor instance)."""
    check(kind, name)
    return _KINDS[kind][2](name, **kwargs)


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(_unknown("registry kind", kind, sorted(_KINDS)))


def _unknown(kind: str, name, known) -> str:
    msg = f"unknown {kind} {name!r}; registered: {', '.join(known)}"
    close = difflib.get_close_matches(str(name), [str(k) for k in known],
                                      n=1, cutoff=0.6)
    if close:
        msg += f" — did you mean {close[0]!r}?"
    return msg
