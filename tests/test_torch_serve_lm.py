"""The serving driver (``repro_torch.launch.serve``) and its sampler
(``repro_torch.random.gumbel`` / ``categorical``) against the reference
package on the CPU.

The Gumbel noise and the categorical draws equal JAX's bit for bit (the
same threefry bits, XLA's ``log``, ties to the lower index) in float32
and bfloat16. ``generate`` is held token for token to the reference's
(whose decode step is jitted): greedy on reduced mamba2-130m (the
reference's own system-test case) and on reduced musicgen-medium (the
(B, K) codebook tokens), and sampled at temperature 0.7 on mamba2-130m.
The logits of the two packages part by about 1e-6 of their scale
(``tests/test_torch_decode.py``); the smallest gap between the two
best scores of any pick here was 5.5e-3 (greedy, mamba2-130m), 1.5e-2
(greedy, musicgen-medium) and 0.57 (sampled at 0.7, the Gumbel noise
included), far above that, so no pick can flip.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import init_params as jax_init
from repro_torch import random as R
from repro_torch.configs import get_config
from repro_torch.convert import key_from_numpy, tree_from_numpy
from repro_torch.launch import serve
from repro_torch.models import decode_step, init_cache

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(5,), (4, 512), (2, 4, 512), (3, 50280)])
def test_gumbel_bit_for_bit(dtype, shape):
    jdt, tdt = DTYPES[dtype]
    for seed in (0, 7):
        want = jax.random.gumbel(jax.random.PRNGKey(seed), shape, jdt)
        got = R.gumbel(R.PRNGKey(seed), shape, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(_bits(got.float().numpy()),
                                      _bits(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("temperature", [0.3, 0.7, 1.0, 1.3])
@pytest.mark.parametrize("shape", [(4, 512), (2, 4, 512), (3, 50280)])
def test_categorical_bit_for_bit(dtype, temperature, shape):
    """The draws of ``_pick``'s sampled branch on equal logits, the
    temperature's division included, over several steps' keys."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(shape[-1]).standard_normal(shape) * 3
    jl = jnp.asarray(x, jnp.float32).astype(jdt)
    tl = torch.as_tensor(np.array(jl.astype(jnp.float32))).to(tdt)
    key = jax.random.PRNGKey(3)
    for t in range(3):
        want = jax_serve._pick(jl, temperature, key, t)
        got = serve._pick(tl, temperature, key_from_numpy(key), t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_categorical_ties_go_to_the_lower_index():
    logits = torch.zeros((2, 6))
    logits[:, 2] = logits[:, 4] = 50.0
    got = R.categorical(R.PRNGKey(0), logits)
    want = jax.random.categorical(jax.random.PRNGKey(0),
                                  jnp.asarray(logits.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _models(arch, seed=0):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    key = jax.random.PRNGKey(seed)
    jparams = jax_init(key, jcfg)
    return jcfg, cfg, key, jparams, tree_from_numpy(jparams)


def _margins(cfg, params, prompt, out, temperature, key) -> float:
    """The smallest gap between the two best scores of any pick of
    ``out``: the logits (over the temperature, plus the step's Gumbel
    noise when sampling), teacher-forced through the port's steps."""
    seq = torch.cat([prompt, out], dim=1)
    cache = init_cache(cfg, seq.shape[0], seq.shape[1])
    gaps = []
    for t in range(seq.shape[1] - 1):
        logits, cache = decode_step(params, cfg, cache, seq[:, t])
        if t < prompt.shape[1] - 1:
            continue
        score = logits
        if temperature > 0:
            step = t - (prompt.shape[1] - 1)
            score = logits / torch.tensor(temperature) + R.gumbel(
                R.fold_in(key, step), tuple(logits.shape))
        top = torch.topk(score, 2, dim=-1).values
        gaps.append(float((top[..., 0] - top[..., 1]).min()))
    return min(gaps)


@pytest.mark.parametrize("arch,temperature", [
    ("mamba2-130m", 0.0), ("musicgen-medium", 0.0), ("mamba2-130m", 0.7)])
def test_generate_matches_reference(arch, temperature):
    """prompt (2, 5[, K]), 7 generated tokens, as the reference's system
    test; the tokens equal the reference's one for one."""
    jcfg, cfg, key, jparams, params = _models(arch)
    shape = (2, 5) if cfg.num_codebooks == 1 else (2, 5, cfg.num_codebooks)
    jprompt = jax.random.randint(key, shape, 0, jcfg.vocab_size)
    want = np.asarray(jax_serve.generate(jcfg, jparams, jprompt, 7,
                                         temperature=temperature, key=key))
    prompt = torch.as_tensor(np.array(jprompt)).long()
    tkey = key_from_numpy(key)
    got = serve.generate(cfg, params, prompt, 7, temperature=temperature,
                         key=tkey)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert _margins(cfg, params, prompt, got, temperature, tkey) > 1e-4


def test_main_on_the_cpu_matches_reference_generate():
    """The CLI on the CPU: its prompt and parameters are the reference
    main's (``randint`` and the init from the seed's key), so its tokens
    are the reference's."""
    res = serve.main(["--arch", "mamba2-130m", "--reduced", "--batch", "2",
                      "--prompt-len", "4", "--gen-len", "5", "--seed", "3",
                      "--device", "cpu"])
    assert tuple(res["tokens"].shape) == (2, 5)
    assert res["steady_s"] > 0 and res["tokens_per_s"] > 0
    jcfg, _, key, jparams, _ = _models("mamba2-130m", seed=3)
    jprompt = jax.random.randint(key, (2, 4), 0, jcfg.vocab_size)
    want = jax_serve.generate(jcfg, jparams, jprompt, 5, key=key)
    np.testing.assert_array_equal(res["tokens"].numpy(), np.asarray(want))
