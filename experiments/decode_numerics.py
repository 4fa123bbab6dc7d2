"""What a decode step costs in host operations, and how far float32
decoding can agree with the float32 forward at depth, and why.

    PYTHONPATH=src python experiments/decode_numerics.py --part ops|depth
    python3 experiments/decode_numerics.py --part card       (on the card)

``ops`` and ``depth`` run on the CPU:
- ``ops``: the aten operations one ``decode_step`` dispatches (a
  ``TorchDispatchMode`` count, views included) at the depth each LM
  model runs at on the card (qwen3-1.7b 28 layers, deepseek-v2-lite-16b
  3, mamba2-130m 24, recurrentgemma-2b 8), at the reduced widths: the
  count does not depend on the widths;
- ``depth``: the largest gap between teacher-forced decode logits and
  the forward's over 4 x 48 tokens, in the reference (jitted decode
  step) and in the port, on the same reduced parameters, with mamba2-130m
  at 2, 8 and 24 layers and qwen3-1.7b and recurrentgemma-2b beside it;
  and the port's gap with its whole computation in float64.

``card`` runs the port alone on the card at full width (mamba2-130m 24
layers, qwen3-1.7b 28, recurrentgemma-2b cut to 8), from the seed's
init, over the serve CLI's prompt of 16 tokens said three times: the
float32 logits' gap, the float32 forward's own move when its embedding
changes by one rounding (each entry times 1 +- 2^-23), each block's
decode against its own forward on the forward's input to it, and the
same logits' gap with the whole computation in float64 (the port's
float32 casts, and the float32 zeros and aranges it makes, made float64
for that run). Every part prints one JSON line.
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
sys.path.insert(0, str(ROOT))

CARD_DEPTHS = {"qwen3-1.7b": 28, "deepseek-v2-lite-16b": 3,
               "mamba2-130m": 24, "recurrentgemma-2b": 8}
B, S = 4, 48


def part_ops() -> dict:
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    out = {}
    for arch, layers in CARD_DEPTHS.items():
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  num_layers=layers)
        params = init_params(R.PRNGKey(0), cfg)
        cache = init_cache(cfg, B, S)
        tok = torch.zeros(B, dtype=torch.long)
        _, cache = decode_step(params, cfg, cache, tok)
        Count.n = 0
        with Count():
            decode_step(params, cfg, cache, tok)
        out[arch] = {"layers": layers, "aten_ops_per_step": Count.n}
    return out


def _gap(dec, full) -> float:
    return float(np.abs(np.asarray(dec, np.float64)
                        - np.asarray(full, np.float64)).max())


def part_depth() -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import decode_step as jax_step
    from repro.models import forward as jax_forward
    from repro.models import init_cache as jax_cache
    from repro.models import init_params as jax_init
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_from_numpy
    from repro_torch.models import decode_step, forward, init_cache
    step = jax.jit(jax_step, static_argnames=("cfg",))
    out = {}
    for arch, layers in (("mamba2-130m", 2), ("mamba2-130m", 8),
                         ("mamba2-130m", 24), ("qwen3-1.7b", 28),
                         ("recurrentgemma-2b", 8)):
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                                   num_layers=layers)
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  num_layers=layers)
        jparams = jax_init(jax.random.PRNGKey(0), jcfg)
        params = tree_from_numpy(jparams)
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
        jfull, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                               "labels": jnp.asarray(toks)})
        jc, jdec = jax_cache(jcfg, B, S), []
        for t in range(S):
            lg, jc = step(jparams, jcfg, jc, jnp.asarray(toks[:, t],
                                                          jnp.int32))
            jdec.append(np.asarray(lg))
        tt = torch.as_tensor(toks)
        full, _ = forward(params, cfg, {"tokens": tt, "labels": tt})
        c, dec = init_cache(cfg, B, S), []
        for t in range(S):
            lg, c = decode_step(params, cfg, c, tt[:, t])
            dec.append(lg)
        out[f"{arch} {layers} layers"] = {
            "reference_gap": _gap(np.stack(jdec, 1), jfull),
            "port_gap": _gap(torch.stack(dec, 1).numpy(),
                             full.detach().numpy()),
            "port_float64_gap": _float64_gap(cfg, params, tt),
            "logit_scale": float(np.abs(np.asarray(jfull)).max())}
    return out


def _float64_gap(cfg, params, seq) -> float:
    """The logits' gap with the port's code in float64 throughout: its
    ``Tensor.float`` casts, and the float32 tensors it makes (``zeros``:
    the SSD's first state, the recurrent caches; ``arange``: RoPE's
    frequencies), made float64 for the run."""
    from repro_torch.models import decode_step, forward, init_cache
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    orig = torch.Tensor.float, torch.zeros, torch.arange

    def wide(fn):
        def make(*a, dtype=None, **k):
            return fn(*a, dtype=(torch.float64 if dtype == torch.float32
                                 else dtype), **k)
        return make

    torch.Tensor.float = lambda self: self.double()
    torch.zeros, torch.arange = wide(orig[1]), wide(orig[2])
    try:
        p64 = {k: v.double() for k, v in params.items()}
        cache, dec = init_cache(cfg64, B, S, seq.device), []
        for t in range(S):
            lg, cache = decode_step(p64, cfg64, cache, seq[:, t])
            dec.append(lg)
        full, _ = forward(p64, cfg64, {"tokens": seq, "labels": seq})
        return float((torch.stack(dec, 1) - full).abs().max())
    finally:
        torch.Tensor.float, torch.zeros, torch.arange = orig


def part_card() -> dict:
    import chip_smoke as C
    from repro_torch import random as R
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_cache
    from repro_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    C.register_ssm_cut()
    out = {"card": C.gpu_line()}
    for arch in ("mamba2-130m", "qwen3-1.7b", C.LM_SSM_RG_ARCH):
        cfg = get_config(arch)
        params = init_params(R.PRNGKey(0, device=dev), cfg)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = {k: v.float() for k, v in params.items()}
        del params
        prompt = C._decode_prompt(cfg, dev)
        seq = torch.cat([prompt] * (S // prompt.shape[1]), 1)
        cache, dec = init_cache(cfg32, B, S, dev), []
        for t in range(S):
            lg, cache = decode_step(p32, cfg32, cache, seq[:, t])
            dec.append(lg)
        full, _ = forward(p32, cfg32, {"tokens": seq, "labels": seq})
        resp, resp_over = C._rounding_response(cfg32, p32, seq, full)
        row = {"float32_gap": float((torch.stack(dec, 1) - full).abs().max()),
               "logit_scale": float(full.abs().max()),
               "rounding_response": resp,
               "rounding_response_over_rtol": resp_over,
               "block_overs_max": max(C._block_overs(cfg32, p32, seq))}
        del dec, full, cache
        row["float64_gap"] = _float64_gap(cfg32, p32, seq)
        out[arch] = row
        del p32
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", required=True, choices=("ops", "depth",
                                                      "card"))
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    got = {"ops": part_ops, "depth": part_depth,
           "card": part_card}[args.part]()
    print(json.dumps({"part": args.part, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
