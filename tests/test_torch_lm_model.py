"""The dense decoder LM (``repro_torch.configs``, ``models``, the LM part of
``data.synthetic``) against the reference package on the CPU.

Tolerances: the parameter keys and shapes, the init, the token stream and
the label corruption are equal, bit for bit. The init is compared with
the reference's eager init, which is what ``repro.api.run`` draws (under
``jax.jit`` XLA folds 1/sqrt(fan_in) and the normal's sqrt(2) into one
constant and the leaves part by an ulp). Losses and gradients are held to
``jax.jit(jax.value_and_grad(loss_fn))``: XLA's CPU dots sum in another
order than torch's, so float32 losses agree to LOSS_TOL relative and
each gradient leaf to GRAD_TOL of its largest entry. In bfloat16 every
projection, norm and residual rounds to 8 significant bits, where XLA
keeps some fused intermediates in float32: the loss is held to
BF16_LOSS_TOL relative and each gradient leaf to BF16_GRAD_TOL of its
largest entry (a few roundings of 2⁻⁸; 1.6e-4 and 2.2e-2 measured).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.data import TokenStream as JaxTokenStream
from repro.data import corrupt_labels_lm as jax_corrupt
from repro.models import init_params as jax_init
from repro.models import layers as jax_layers
from repro.models import loss_fn as jax_loss
from repro_torch import random as R
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import tree_from_numpy
from repro_torch.data import TokenStream, corrupt_labels_lm
from repro_torch.models import init_params, layers, loss_fn, param_shapes

DENSE = ("qwen3-1.7b", "starcoder2-3b", "llama3-405b", "mistral-large-123b",
         "qwen2-vl-2b", "musicgen-medium")
# the loss's code paths: qk-norm, GQA without it (llama3-405b and
# mistral-large-123b reduce to the same blocks), M-RoPE with a frontend,
# codebooks with a frontend
LOSS_CONFIGS = ("qwen3-1.7b", "starcoder2-3b", "qwen2-vl-2b",
                "musicgen-medium")
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
BF16_LOSS_TOL = 1e-3
BF16_GRAD_TOL = 5e-2


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jax_flat(tree) -> dict:
    return {_path(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", sorted(list_configs()))
def test_keys_walk_the_reference_tree_in_its_order(name, reduced):
    """The port's sorted keys are ``jax.tree.flatten``'s leaf order of the
    reference's nested tree (``jax.eval_shape``, no init), shapes equal,
    for every registered config."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    want = _jax_flat(jax.eval_shape(lambda k: jax_init(k, jcfg),
                                    jax.random.PRNGKey(0)))
    got = param_shapes(cfg)
    assert list(got) == sorted(got) == list(want)
    assert {k: tuple(s) for k, s in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_configs_are_the_references():
    assert list_configs() == jax_list_configs()
    for name in list_configs():
        cfg, jcfg = get_config(name), jax_get_config(name)
        for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
            assert dataclasses.asdict(c) == dataclasses.asdict(j)
            assert c.torch_dtype == getattr(torch, str(j.jnp_dtype))
    assert get_config("qwen3-1.7b").param_count() == 2_031_732_736


@pytest.mark.parametrize("name", DENSE)
def test_init_bit_for_bit(name):
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    want = _jax_flat(jax_init(jax.random.PRNGKey(3), jcfg))
    got = init_params(R.PRNGKey(3), cfg)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.dtype == cfg.torch_dtype
        np.testing.assert_array_equal(_np(v), np.asarray(want[k]), err_msg=k)


def test_init_bf16_bit_for_bit():
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="bfloat16")
    want = _jax_flat(jax_init(jax.random.PRNGKey(5), jcfg))
    got = init_params(R.PRNGKey(5), cfg)
    for k, v in got.items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            v.view(torch.int16).numpy(),
            np.asarray(want[k]).view(np.int16), err_msg=k)


def _stream_kw(cfg, **kw):
    return dict(vocab_size=cfg.vocab_size, seq_len=16, n_workers=3,
                per_worker_batch=2, num_codebooks=cfg.num_codebooks,
                frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model,
                seed=4, **kw)


@pytest.mark.parametrize("name,het", [("qwen3-1.7b", False),
                                      ("qwen3-1.7b", True),
                                      ("qwen2-vl-2b", False),
                                      ("musicgen-medium", True)])
def test_token_stream_and_corruption_bit_for_bit(name, het):
    cfg = get_config(name).reduced()
    js = JaxTokenStream(**_stream_kw(cfg, heterogeneous=het))
    ts = TokenStream(**_stream_kw(cfg, heterogeneous=het))
    mask = np.array([True, False, False])
    for draw in ("minibatch", "anchor"):
        for step in (7,):
            want = getattr(js, draw)(step)
            got = getattr(ts, draw)(step)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
            bad = corrupt_labels_lm(got, torch.as_tensor(mask))["labels"]
            np.testing.assert_array_equal(
                bad.numpy(), np.asarray(jax_corrupt(want,
                                                    jnp.asarray(mask))
                                        ["labels"]))


def _one_worker_batch(cfg, seq_len=16):
    js = JaxTokenStream(**{**_stream_kw(cfg), "seq_len": seq_len})
    batch = jax.tree.map(lambda a: a[1], js.minibatch(2))
    return batch, tree_from_numpy(jax.device_get(batch))


def _value_and_grad(jcfg, cfg, xent_chunk=1024, seq_len=16):
    jparams = jax_init(jax.random.PRNGKey(1), jcfg)
    jbatch, batch = _one_worker_batch(cfg, seq_len)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, jcfg, jbatch, xent_chunk=xent_chunk)))(jparams)
    params = {k: v.requires_grad_(True) for k, v in
              init_params(R.PRNGKey(1), cfg).items()}
    loss = loss_fn(params, cfg, batch, xent_chunk=xent_chunk)
    grads = torch.autograd.grad(loss, [params[k] for k in sorted(params)])
    return (float(jl), _jax_flat(jg)), (float(loss.detach()),
                                        dict(zip(sorted(params), grads)))


def _close(ref, got, loss_tol, grad_tol):
    (jl, jg), (tl, tg) = ref, got
    assert abs(tl - jl) <= loss_tol * abs(jl), (tl, jl)
    assert list(tg) == list(jg)
    for k, g in tg.items():
        want = np.asarray(jg[k]).astype(np.float32)
        err = np.abs(_np(g) - want).max()
        assert err <= grad_tol * max(np.abs(want).max(), 1e-30), (k, err)


@pytest.mark.parametrize("name", LOSS_CONFIGS)
def test_loss_and_grads(name):
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    _close(*_value_and_grad(jcfg, cfg), LOSS_TOL, GRAD_TOL)


@pytest.fixture
def attention_form():
    """Set the attention module cells of both packages, restore them."""
    saved = (jax_layers.Q_CHUNK[0], jax_layers.ATTN_IMPL[0],
             layers.Q_CHUNK[0], layers.ATTN_IMPL[0])

    def set_form(q_chunk=1024, impl="chunked"):
        jax_layers.Q_CHUNK[0] = layers.Q_CHUNK[0] = q_chunk
        jax_layers.ATTN_IMPL[0] = layers.ATTN_IMPL[0] = impl

    yield set_form
    (jax_layers.Q_CHUNK[0], jax_layers.ATTN_IMPL[0], layers.Q_CHUNK[0],
     layers.ATTN_IMPL[0]) = saved


@pytest.mark.parametrize("form", ["chunked", "online"])
def test_loss_and_grads_other_forms(form, attention_form):
    """The query-chunked attention and the sequence-chunked cross entropy
    (two chunks each) on qwen3-1.7b; the online softmax on qwen2-vl-2b,
    whose 4 frontend rows precede the text."""
    name = "qwen2-vl-2b" if form == "online" else "qwen3-1.7b"
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    if form == "chunked":
        attention_form(q_chunk=8)
    else:
        attention_form(impl="online")
    kw = {"xent_chunk": 8} if form == "chunked" else {}
    _close(*_value_and_grad(jcfg, cfg, **kw), LOSS_TOL, GRAD_TOL)


def test_loss_and_grads_bf16():
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="bfloat16")
    _close(*_value_and_grad(jcfg, cfg), BF16_LOSS_TOL, BF16_GRAD_TOL)


def test_online_softmax_guards_rows_with_every_key_masked():
    """A query row whose keys are all masked (a sliding window of 1 over
    positions that only see the future here) gives finite zeros, as the
    reference's guards give."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 2, 8, generator=g) for _ in range(3))
    q_pos = torch.arange(4)[None]
    k_pos = q_pos + 10                     # every key after every query
    out = layers._attend_online(q, k, v, q_pos, k_pos)
    want = jax_layers._attend_online(*(jnp.asarray(t.numpy())
                                       for t in (q, k, v)),
                                     jnp.asarray(q_pos.numpy()),
                                     jnp.asarray(k_pos.numpy()))
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_unported_blocks_raise_with_their_item():
    for name, item in (("phi3.5-moe-42b-a6.6b", 14),
                       ("deepseek-v2-lite-16b", 14), ("mamba2-130m", 15),
                       ("recurrentgemma-2b", 15)):
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP queue 1, item {item}"):
            init_params(R.PRNGKey(0), get_config(name).reduced())
    from repro_torch.models import transformer
    cfg = get_config("qwen3-1.7b").reduced()
    with pytest.raises(NotImplementedError, match="torch.func"):
        transformer.apply_stack(init_params(R.PRNGKey(0), cfg), cfg,
                                torch.zeros(1, 4, cfg.d_model),
                                torch.arange(4)[None], remat=True)
