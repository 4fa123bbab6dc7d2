"""Serving driver: batched autoregressive decoding with KV and recurrent
caches (port of ``repro/launch/serve.py``). Runs on the card unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --reduced --batch 4 --prompt-len 16 --gen-len 32

The prompt is teacher-forced through decode steps, then ``gen_len``
tokens are decoded greedily, or sampled at ``--temperature`` with the
key ``fold_in(key, t)`` at step t (``random.categorical``, JAX's
Gumbel-max draw bit for bit). A step reads nothing back to the host, so
a whole generation is enqueued on the card without a sync.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import random as R
from repro_torch.api.runner import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import decode_step, init_cache, init_params


def generate(cfg, params, prompt, gen_len: int, *, temperature: float = 0.0,
             key=None, capacity: int | None = None):
    """prompt: (B, S[, K]) int. Greedy (or sampled) continuation, (B,
    gen_len[, K]) int64, on the prompt's device."""
    b, s = prompt.shape[0], prompt.shape[1]
    cache = init_cache(cfg, b, capacity or (s + gen_len), prompt.device)
    # prefill through decode steps (the prompt teacher-forced)
    logits = None
    for t in range(s):
        logits, cache = decode_step(params, cfg, cache, prompt[:, t])
    outs = []
    tok = _pick(logits, temperature, key, 0)
    for t in range(gen_len):
        outs.append(tok)
        logits, cache = decode_step(params, cfg, cache, tok)
        tok = _pick(logits, temperature, key, t + 1)
    return torch.stack(outs, dim=1)


def _pick(logits, temperature, key, t):
    """logits: (B, V) or (B, K, V) -> the argmax, or at a positive
    temperature a draw under ``fold_in(key, t)``. The temperature divides
    as a tensor, so the card takes a true division too (a Python scalar
    divisor becomes a product by its reciprocal there)."""
    if temperature <= 0.0 or key is None:
        return torch.argmax(logits, dim=-1)
    temp = torch.tensor(temperature, dtype=logits.dtype,
                        device=logits.device)
    return R.categorical(R.fold_in(key, t), logits / temp)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="batched autoregressive decoding (repro_torch.models)")
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         '"cpu" for the plain PyTorch path)')
    return ap


def main(argv=None) -> dict:
    """Parse ``argv``, generate twice (a warm call, then the timed one,
    each ended on a device sync) and print the steady tokens/s. ->
    {"tokens", "first_s", "steady_s", "tokens_per_s"}."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    key = R.PRNGKey(args.seed, device=dev)
    params = init_params(key, cfg)
    shape = ((args.batch, args.prompt_len) if cfg.num_codebooks == 1 else
             (args.batch, args.prompt_len, cfg.num_codebooks))
    prompt = R.randint(key, shape, 0, cfg.vocab_size)

    def timed():
        t0 = time.perf_counter()
        out = generate(cfg, params, prompt, args.gen_len,
                       temperature=args.temperature, key=key)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    out, t_first = timed()
    out, t_steady = timed()
    toks = args.batch * args.gen_len
    print(f"[serve] {args.arch} on {dev}: generated {tuple(out.shape)} — "
          f"first call {t_first:.2f}s ({toks / t_first:.1f} tok/s), "
          f"steady-state {t_steady:.2f}s ({toks / t_steady:.1f} tok/s)")
    print(out[0][:16].tolist())
    return {"tokens": out, "first_s": t_first, "steady_s": t_steady,
            "tokens_per_s": toks / t_steady}


if __name__ == "__main__":
    main()
