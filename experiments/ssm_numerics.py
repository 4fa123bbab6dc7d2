"""How far the SSD and RG-LRU models' float32 and bfloat16 numbers can
agree with the reference, and why.

    PYTHONPATH=src python experiments/ssm_numerics.py --part ssd|grads|traj
    python3 experiments/ssm_numerics.py --part step        (on the card)

``ssd``, ``grads`` and ``traj`` run on the CPU with the JAX package
beside the port:
- ``ssd``: ``_ssd_chunked`` over 64 steps in 1, 2 and 4 chunks (the
  inputs of ``tests/test_torch_lm_ssm.py``), each input's gradient as
  the port's, the reference's (jitted) and a float64 step-by-step
  recurrence give it, with the port's chunk cumsum as it is
  (``xla_math.cumsum``, XLA's order) and swapped for ``torch.cumsum``;
- ``grads``: one worker's loss gradient (4 x 128 tokens) on mamba2-130m
  at full width cut to 2 layers (float32 and bfloat16) and at the
  reduced width with 24 layers (float32): each leaf's largest error of
  the reference and of the port against the port's own code run in
  float64 (``Tensor.float`` made a float64 cast for that run);
- ``traj``: the 4-round MARINA runs of ``tests/test_torch_lm_ssm_train
  .py``: each leaf's largest error of the port against the reference on
  gspmd, and of the reference's pallas run against its gspmd run.

``step`` runs the port alone on the card: mamba2-130m at full width, 6
and 24 layers, one worker's loss and gradient norms at the init, and
the loss after one SGD step of lr 3e-3, 1e-3 and 3e-4; and the time of
one worker's gradient at full width (24 layers, bfloat16) with the
SSD's chunk cumsum in XLA's order and as one ``torch.cumsum``. Every
part prints one JSON line.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def _rel(a, b, scale=None) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()
                 / (np.abs(b).max() if scale is None else scale))


def _as_float64():
    """Run the port's code in float64: its float32 casts become float64
    casts (restore ``torch.Tensor.float`` after)."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    return orig


def part_ssd() -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models import layers as jax_layers
    from repro_torch import xla_math as X
    from repro_torch.models import layers
    from test_torch_lm_ssm import _ssd_float64
    out = {}
    for cumsum in ("xla_math", "torch"):
        if cumsum == "torch":
            layers.X = type("X", (), {"cumsum": staticmethod(
                lambda x, dim: torch.cumsum(x, dim))})
        for chunk in (64, 32, 16):
            g = np.random.default_rng(chunk)
            b, t, h, p, n = 2, 64, 4, 8, 16
            inputs = (g.standard_normal((b, t, h, p)),
                      g.standard_normal((b, t, n)),
                      g.standard_normal((b, t, n)),
                      np.log1p(np.exp(g.standard_normal((b, t, h)))),
                      np.log(np.linspace(1, 16, h)))
            inputs = tuple(a.astype(np.float32) for a in inputs)
            py = g.standard_normal((b, t, h, p)).astype(np.float32)
            ps = g.standard_normal((b, h, n, p)).astype(np.float32)

            def obj(args, chunk=chunk, py=py, ps=ps):
                y, s = jax_layers._ssd_chunked(*args, chunk=chunk)
                return jnp.sum(y * py) + jnp.sum(s * ps)

            jg = jax.jit(jax.grad(obj))(tuple(map(jnp.asarray, inputs)))
            targs = [torch.tensor(a, requires_grad=True) for a in inputs]
            y, s = layers._ssd_chunked(*targs, chunk=chunk)
            tg = torch.autograd.grad((y * torch.as_tensor(py)).sum()
                                     + (s * torch.as_tensor(ps)).sum(),
                                     targs)
            a64 = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
                   for a in inputs]
            y64, s64 = _ssd_float64(*a64)
            eg = torch.autograd.grad((y64 * torch.as_tensor(py)).sum()
                                     + (s64 * torch.as_tensor(ps)).sum(),
                                     a64)
            out[f"{cumsum} cumsum, chunk {chunk}"] = {
                name: {"port_vs_ref": _rel(tv.numpy(), jv),
                       "ref_vs_f64": _rel(jv, ev.numpy()),
                       "port_vs_f64": _rel(tv.numpy(), ev.numpy())}
                for name, tv, jv, ev in zip(("xh", "b", "c", "dt", "a_log"),
                                            tg, jg, eg)}
    layers.X = X
    return out


def _grads_case(jcfg, cfg) -> dict:
    import jax
    from repro.data import TokenStream as JaxTokenStream
    from repro.models import init_params as jax_init
    from repro.models import loss_fn as jax_loss
    from repro_torch import random as R
    from repro_torch.convert import tree_from_numpy
    from repro_torch.models import init_params, loss_fn
    from test_torch_lm_ssm import _jax_flat
    jp, tp = jax_init(jax.random.PRNGKey(1), jcfg), init_params(
        R.PRNGKey(1), cfg)
    js = JaxTokenStream(vocab_size=cfg.vocab_size, seq_len=128, n_workers=1,
                        per_worker_batch=4, num_codebooks=1,
                        frontend_tokens=0, d_model=cfg.d_model, seed=4)
    jb = jax.tree.map(lambda a: a[0], js.minibatch(0))
    batch = tree_from_numpy(jax.device_get(jb))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_loss(p, jcfg, jb)))(jp)
    jg = _jax_flat(jg)

    def port(dtype):
        p = {k: v.clone().to(dtype).requires_grad_(True)
             for k, v in tp.items()}
        loss = loss_fn(p, cfg, batch)
        return float(loss), dict(zip(sorted(p), torch.autograd.grad(
            loss, [p[k] for k in sorted(p)])))

    tl, tg = port(cfg.torch_dtype)
    orig = _as_float64()
    try:
        el, eg = port(torch.float64)
    finally:
        torch.Tensor.float = orig
    leaves = {}
    for k in sorted(tg):
        exact = eg[k].numpy()
        scale = np.abs(exact).max()
        leaves[k] = {"ref_vs_f64": _rel(np.asarray(jg[k], np.float32), exact,
                                        scale),
                     "port_vs_f64": _rel(tg[k].float().numpy(), exact, scale),
                     "grad_max": float(scale)}
    return {"loss": {"ref": float(jl), "port": tl, "f64": el},
            "leaves": leaves}


def part_grads() -> dict:
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    out = {}
    for tag, layers_, reduced, dtype in (
            ("full width, 2 layers, float32", 2, False, "float32"),
            ("full width, 2 layers, bfloat16", 2, False, "bfloat16"),
            ("reduced width, 24 layers, float32", 24, True, "float32")):
        cfgs = []
        for get in (jax_get_config, get_config):
            c = get("mamba2-130m")
            c = c.reduced() if reduced else c
            cfgs.append(dataclasses.replace(c, num_layers=layers_,
                                            dtype=dtype))
        out[tag] = _grads_case(*cfgs)
    return out


def part_traj() -> dict:
    from repro.api import RunSpec as JaxRunSpec
    from repro.api import run as jax_run
    from repro_torch.api import RunSpec, run
    from test_torch_lm_ssm_train import LM, SSM, _flat
    out = {}
    for name in SSM:
        ref = {mode: _flat(jax_run(JaxRunSpec(**{**LM, "arch": name,
                                                  "agg_mode": mode}),
                                   log_every=1).state["params"])
               for mode in ("gspmd", "pallas")}
        got = run(RunSpec(**{**LM, "arch": name, "agg_mode": "gspmd"}),
                  device="cpu", log_every=1).params
        out[name] = {k: {"port_vs_ref": _rel(got[k].numpy(), w),
                         "ref_pallas_vs_gspmd": _rel(ref["pallas"][k], w),
                         "abs": float(np.abs(got[k].numpy() - w).max())}
                     for k, w in ref["gspmd"].items()}
    return out


def part_step() -> dict:
    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import init_params, loss_fn
    dev = torch.device("cuda")
    out = {"card": torch.cuda.get_device_name(0)}
    for layers_ in (6, 24):
        cfg = dataclasses.replace(get_config("mamba2-130m"),
                                  num_layers=layers_, dtype="float32")
        params = init_params(R.PRNGKey(1, device=dev), cfg)
        ts = TokenStream(vocab_size=cfg.vocab_size, seq_len=128, n_workers=1,
                         per_worker_batch=4, num_codebooks=1,
                         frontend_tokens=0, d_model=cfg.d_model, seed=4)
        batch = {k: v[0].to(dev) for k, v in ts.minibatch(0).items()}
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p, cfg, batch)
        grads = dict(zip(sorted(p), torch.autograd.grad(
            loss, [p[k] for k in sorted(p)])))
        row = {"loss": float(loss),
               "grad_norm": {k: float(v.norm()) for k, v in grads.items()}}
        with torch.no_grad():
            for lr in (3e-3, 1e-3, 3e-4):
                q = {k: v - lr * grads[k] for k, v in params.items()}
                row[f"loss after lr {lr}"] = float(loss_fn(q, cfg, batch))
        out[f"{layers_} layers"] = row
        del params, p, grads
        torch.cuda.empty_cache()
    out["cumsum cost"] = _cumsum_cost(dev)
    return out


def _cumsum_cost(dev) -> dict:
    """ms of one worker's loss and gradient on mamba2-130m at full width
    (24 layers, bfloat16, 4 x 128 tokens) with the SSD's chunk cumsum in
    XLA's order (``xla_math.cumsum``) and as one ``torch.cumsum``, in the
    order A B B A, 5 calls each after a warm one."""
    from repro_torch import random as R
    from repro_torch import xla_math as X
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import init_params, layers, loss_fn
    cfg = get_config("mamba2-130m")
    params = init_params(R.PRNGKey(1, device=dev), cfg)
    ts = TokenStream(vocab_size=cfg.vocab_size, seq_len=128, n_workers=1,
                     per_worker_batch=4, num_codebooks=1, frontend_tokens=0,
                     d_model=cfg.d_model, seed=4)
    batch = {k: v[0].to(dev) for k, v in ts.minibatch(0).items()}
    plain = type("X", (), {"cumsum": staticmethod(torch.cumsum)})

    def grad_ms(xm) -> float:
        layers.X = xm
        fn = torch.func.grad(lambda p: loss_fn(p, cfg, batch))
        fn(params)
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(5):
            fn(params)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 5

    times = {"xla_math": [], "torch": []}
    for name in ("xla_math", "torch", "torch", "xla_math"):
        times[name].append(grad_ms(X if name == "xla_math" else plain))
    layers.X = X
    return {k: v for k, v in times.items()}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("ssd", "grads", "traj", "step"),
                    required=True)
    args = ap.parse_args(argv)
    if args.part == "step" and not torch.cuda.is_available():
        print("ssm_numerics --part step: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    got = globals()[f"part_{args.part}"]()
    print(json.dumps({"part": args.part, **got}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
