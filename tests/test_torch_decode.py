"""LM decoding (``repro_torch.models.init_cache`` / ``decode_step``)
against the reference package on the CPU, for every assigned config at
its ``reduced()`` size, and the port twins of the reference's own
decode checks (``tests/test_decode.py``).

Tolerances: an empty cache equals the reference's (``convert
.flatten_tree`` of it) in keys, shapes, dtypes and values. Eight decode
steps from the same parameters and tokens hold the logits and every
cache leaf within DECODE_TOL of the reference's largest entry in
float32 (the reference jitted: XLA's CPU dots sum in another order than
torch's; the worst measured was 3.3e-6 of the largest logit, on
recurrentgemma-2b, and 7.2e-7 to 1.2e-6 on the others, each config's
worst leaf its logits); positions and counts are equal. In bfloat16 the
teacher-forced loss of the decode logits is held to BF16_LOSS_TOL
relative (ROADMAP queue 3's LM tolerances). Decode against the port's
own forward takes the reference's atol 2e-4, rtol 2e-3.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro_torch.configs import get_config
from repro_torch.convert import flatten_tree, tree_from_numpy
from repro_torch.models import decode_step, forward, init_cache

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

DECODE_TOL = 1e-5
BF16_LOSS_TOL = 1e-3
B, STEPS = 2, 8

_jax_step = jax.jit(jax_decode_step, static_argnames=("cfg",))


def _tokens(cfg, b, s, seed=0) -> np.ndarray:
    shape = (b, s) if cfg.num_codebooks == 1 else (b, s, cfg.num_codebooks)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _at(toks, t):
    return toks[:, t] if toks.ndim == 2 else toks[:, t, :]


def _decode_both(jcfg, cfg, steps):
    """The same parameters and tokens through ``steps`` decode steps of
    each package -> (jax logits, port logits, jax cache, port cache)."""
    jparams = jax_init(jax.random.PRNGKey(1), jcfg)
    params = tree_from_numpy(jparams)
    toks = _tokens(cfg, B, steps)
    jc, c = jax_init_cache(jcfg, B, steps), init_cache(cfg, B, steps)
    jl, tl = [], []
    for t in range(steps):
        lg, jc = _jax_step(jparams, jcfg, jc, jnp.asarray(_at(toks, t),
                                                          jnp.int32))
        jl.append(np.asarray(lg, np.float32))
        lg, c = decode_step(params, cfg, c, torch.as_tensor(_at(toks, t)))
        tl.append(lg.float().numpy())
    return np.stack(jl, 1), np.stack(tl, 1), flatten_tree(jc), c, toks


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_init_cache_equals_reference(arch):
    """Keys, shapes, dtypes and values of the empty cache, the groups'
    leading axis and the broadcast ``len`` included."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    want = {k: np.asarray(v) for k, v in
            flatten_tree(jax_init_cache(jcfg, 3, 16)).items()}
    got = init_cache(cfg, 3, 16)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == want[k].dtype.name, k
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decode_steps_match_reference(arch):
    """Eight steps at b = 2 in float32: logits and every cache leaf."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jl, tl, jc, c, _ = _decode_both(jcfg, cfg, STEPS)
    err = np.abs(tl - jl).max()
    assert err <= DECODE_TOL * np.abs(jl).max(), ("logits", err)
    assert sorted(c) == sorted(jc)
    for k, v in c.items():
        want = np.asarray(jc[k])
        got = v.float().numpy() if v.is_floating_point() else v.numpy()
        if not v.is_floating_point():
            np.testing.assert_array_equal(got, want, err_msg=k)
            continue
        want = want.astype(np.float32)
        err = np.abs(got - want).max()
        assert err <= DECODE_TOL * max(np.abs(want).max(), 1e-30), (k, err)


def _nll(logits, toks) -> float:
    """Mean next-token NLL of teacher-forced logits (B, S, V)."""
    lp = torch.log_softmax(torch.as_tensor(logits[:, :-1]), dim=-1)
    nxt = torch.as_tensor(toks[:, 1:])
    return float(-torch.gather(lp, -1, nxt[..., None]).mean())


def test_decode_bf16_loss_matches_reference():
    """qwen3-1.7b reduced in bfloat16: the decode logits' loss."""
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="bfloat16")
    jl, tl, jc, c, toks = _decode_both(jcfg, cfg, STEPS)
    assert c["groups/0/k"].dtype == torch.bfloat16
    want, got = _nll(jl, toks), _nll(tl, toks)
    assert abs(got - want) <= BF16_LOSS_TOL * abs(want), (got, want)


def _decode_all(cfg, params, toks, capacity):
    cache = init_cache(cfg, toks.shape[0], capacity)
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = decode_step(params, cfg, cache,
                                torch.as_tensor(_at(toks, t)))
        outs.append(lg)
    return torch.stack(outs, 1)


def _port_params(arch):
    """The reduced config's parameters (the window does not shape
    them)."""
    return tree_from_numpy(jax_init(jax.random.PRNGKey(1),
                                    jax_get_config(arch).reduced()))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decode_matches_port_forward(arch):
    """Incremental decode equals the port's own full forward (KV cache,
    MLA latent cache, Mamba2 and RG-LRU state)."""
    cfg = get_config(arch).reduced()
    params = _port_params(arch)
    toks = _tokens(cfg, 2, 8, seed=1)
    full, _ = forward(params, cfg, {"tokens": torch.as_tensor(toks),
                                    "labels": torch.as_tensor(toks)})
    dec = _decode_all(cfg, params, toks, 8)
    np.testing.assert_allclose(dec.float().numpy(), full.float().numpy(),
                               atol=2e-4, rtol=2e-3)


def test_sliding_window_ring_buffer():
    """recurrentgemma-2b's local attention at window 8 over 20 tokens:
    the cache (capacity = window) wraps and decode still equals the
    forward with the same window."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              sliding_window=8)
    params = _port_params("recurrentgemma-2b")
    toks = _tokens(cfg, 1, 20, seed=2)
    full, _ = forward(params, cfg, {"tokens": torch.as_tensor(toks),
                                    "labels": torch.as_tensor(toks)})
    cache = init_cache(cfg, 1, cfg.sliding_window)
    swa = [k for k in cache if k.endswith("/pos")]
    assert swa and all(cache[k].shape[-1] == 8 for k in swa)
    dec = _decode_all(cfg, params, toks, cfg.sliding_window)
    np.testing.assert_allclose(dec.float().numpy(), full.float().numpy(),
                               atol=2e-4, rtol=2e-3)


def test_mla_cache_is_compressed():
    """deepseek's MLA cache holds kv_lora + rope_dim a token, not
    2 · heads · head_dim."""
    rcfg = get_config("deepseek-v2-lite-16b").reduced()
    c = init_cache(rcfg, 1, 16)
    assert "groups/0/c_kv" in c and "groups/0/k_rope" in c
    assert "groups/0/k" not in c
    assert c["groups/0/c_kv"].shape[-1] == rcfg.kv_lora_rank
    per_tok = c["groups/0/c_kv"].shape[-1] + c["groups/0/k_rope"].shape[-1]
    assert per_tok < 2 * rcfg.num_kv_heads * rcfg.resolved_head_dim


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_recurrent_state_is_constant_size(arch):
    """The caches do not grow with the capacity: Mamba2's state and conv
    inputs; the RG-LRU's, and the local attention's ring of ``window``
    slots."""
    cfg = get_config(arch).reduced()
    sizes = [sum(v.numel() for v in init_cache(cfg, 2, cap).values())
             for cap in (128, 4096)]
    assert sizes[0] == sizes[1]
