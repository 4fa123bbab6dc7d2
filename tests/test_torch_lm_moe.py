"""MLA and the MoE FFN (``repro_torch.models``) against the reference
package on the CPU, on deepseek-v2-lite-16b (MLA, routed and shared
experts) and phi3.5-moe-42b-a6.6b (GQA attention, routed experts), both
``reduced()``.

Tolerances: the init equals the reference's eager init (what
``repro.api.run`` draws) bit for bit. The routing (top-k indices, gates,
kept assignments and their buffer slots) equals the reference's
compiled routing bit for bit when both start from the same float32
logits, ties to the lower index included. Everything else is held to the
reference under ``jax.jit``: XLA's CPU dots sum in another order than
torch's, so a layer's output and each parameter's gradient agree to
LAYER_TOL / GRAD_TOL of their largest entry, the aux loss and the LM
loss to LOSS_TOL relative, and in bfloat16 the loss to BF16_LOSS_TOL
relative and the gradients to BF16_GRAD_TOL of each leaf's largest entry
(the LM tolerances of ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_config as jax_get_config
from repro.data import TokenStream as JaxTokenStream
from repro.models import init_params as jax_init
from repro.models import layers as jax_layers
from repro.models import loss_fn as jax_loss
from repro_torch import random as R
from repro_torch.configs import get_config
from repro_torch.convert import tree_from_numpy
from repro_torch.models import init_params, layers, loss_fn

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

MOE = ("deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b")
LAYER_TOL = 1e-5
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
    return t.detach().float().numpy()


def _within(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = np.abs(_np(got) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.fixture(scope="module")
def inits():
    """{name: (reduced jax config, port config, reference params, port
    params)}, both drawn from key 1: the reference eagerly, as its
    runner draws."""
    out = {}
    for name in MOE:
        jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
        out[name] = (jcfg, cfg, jax_init(jax.random.PRNGKey(1), jcfg),
                     init_params(R.PRNGKey(1), cfg))
    return out


@pytest.mark.parametrize("name", MOE)
def test_init_bit_for_bit(inits, name):
    """Every leaf, MLA's 7-way split and the expert stacks (fan_in = E)
    included."""
    _, cfg, jparams, params = inits[name]
    want = _jax_flat(jparams)
    assert list(params) == list(want)
    for k, v in params.items():
        assert v.dtype == cfg.torch_dtype
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# the layers on numpy inputs
# ---------------------------------------------------------------------------

def _layer_inputs(shapes: dict, d: int, seed: int, t: int = 16):
    """numpy parameters (normal / sqrt(fan_in), norms small) and an input
    (2, t, d), from ``seed``."""
    g = np.random.default_rng(seed)
    params = {}
    for k, s in shapes.items():
        scale = 0.1 if len(s) == 1 else 1.0 / np.sqrt(s[-2])
        params[k] = (g.standard_normal(s) * scale).astype(np.float32)
    x = g.standard_normal((2, t, d)).astype(np.float32)
    probe = g.standard_normal((2, t, d)).astype(np.float32)
    return params, x, probe


def _nest(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return out


def _held_layer(jax_fn, port_fn, params, x, probe, with_aux):
    """The layer's output (and aux) and the gradients of Σ y·probe (+ aux)
    with respect to every parameter and the input, the reference jitted."""
    def jax_obj(p, xx):
        out = jax_fn(p, xx)
        y, aux = out if with_aux else (out, 0.0)
        return jnp.sum(y * probe) + aux, out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True))(_nest(params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    out = port_fn(tp, tx)
    y, aux = out if with_aux else (out, torch.zeros(()))
    keys = sorted(tp)
    grads = torch.autograd.grad((y * torch.as_tensor(probe)).sum() + aux,
                                [tp[k] for k in keys] + [tx])
    jy = jout[0] if with_aux else jout
    _within(y, jy, LAYER_TOL, "y")
    if with_aux:
        ta, ja = float(aux.detach()), float(jout[1])
        assert abs(ta - ja) <= LOSS_TOL * abs(ja), (ta, ja)
    jflat = _jax_flat(jgp)
    for k, g in zip(keys, grads):
        _within(g, jflat[k], GRAD_TOL, k)
    _within(grads[-1], jgx, GRAD_TOL, "x")


def test_mla_attention_against_the_reference():
    """deepseek's MLA at reduced width: q and k of hd + rd dims, v of hd,
    the shared RoPE key head broadcast over the heads."""
    jcfg, cfg = (jax_get_config(MOE[0]).reduced(),
                 get_config(MOE[0]).reduced())
    params, x, probe = _layer_inputs(layers.mla_shapes(cfg), cfg.d_model, 11)
    pos = np.broadcast_to(np.arange(x.shape[1], dtype=np.int32),
                          x.shape[:2]).copy()
    _held_layer(
        lambda p, xx: jax_layers.mla_attention(p, jcfg, xx, jnp.asarray(pos)),
        lambda p, xx: layers.mla_attention(p, cfg, xx, torch.as_tensor(pos)),
        params, x, probe, with_aux=False)


@pytest.mark.parametrize("name,capacity_factor", [
    (MOE[0], None), (MOE[1], None), (MOE[0], 0.5)])
def test_moe_ffn_against_the_reference(name, capacity_factor):
    """y and the aux loss of the MoE FFN at reduced width (4 experts, top
    2, capacity factor 2; deepseek with one shared expert) on seeded
    inputs, and the gradients through the dispatch and the gates; at
    capacity factor 0.5 a third of the assignments overflow into the
    dropped slot. The routing from the port's own logits is first checked
    to be the reference's (no near-tie flips an expert on these
    inputs)."""
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    if capacity_factor is not None:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jcfg, cfg))
    params, x, probe = _layer_inputs(layers.moe_shapes(cfg), cfg.d_model, 12)
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    cap = int(m.capacity_factor * t * m.top_k / m.num_experts) + 1
    tl = torch.einsum("td,de->te", torch.as_tensor(x).reshape(t, -1),
                      torch.as_tensor(params["router"]))
    jl = jax.jit(lambda a, w: jnp.einsum("td,de->te", a, w))(
        x.reshape(t, -1), params["router"])
    got = layers.moe_route(tl, m.top_k, cap)
    want = _jax_route(jl, m.top_k, cap)
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    if capacity_factor is not None:
        assert not got["keep"].all()
    _held_layer(lambda p, xx: jax_layers.moe_ffn(p, jcfg, xx),
                lambda p, xx: layers.moe_ffn(p, cfg, xx),
                params, x, probe, with_aux=True)


# ---------------------------------------------------------------------------
# the routing, bit for bit
# ---------------------------------------------------------------------------

# the lines of the reference's moe_ffn from the router's float32 logits to
# the buffer slots, which _jax_route repeats verbatim
ROUTING_LINES = (
    "probs = jax.nn.softmax(logits, axis=-1)",
    "gate, idx = lax.top_k(probs, k)",
    "gate = gate / jnp.clip(gate.sum(-1, keepdims=True), 1e-9)",
    "flat_e = idx.reshape(-1)",
    "flat_t = jnp.repeat(jnp.arange(t), k)",
    "flat_g = gate.reshape(-1)",
    "order = jnp.argsort(flat_e, stable=True)",
    "se, st, sg = flat_e[order], flat_t[order], flat_g[order]",
    "counts = jnp.bincount(se, length=e)",
    "starts = jnp.cumsum(counts) - counts",
    "rank = jnp.arange(t * k) - starts[se]",
    "keep = rank < cap",
    "dest = jnp.where(keep, se * cap + rank, e * cap)",
)


def _jax_route(logits, k, cap):
    """The reference's routing (ROUTING_LINES), jitted."""
    def route(logits):
        t, e = logits.shape
        probs = jax.nn.softmax(logits, axis=-1)
        gate, idx = lax.top_k(probs, k)
        gate = gate / jnp.clip(gate.sum(-1, keepdims=True), 1e-9)
        flat_e = idx.reshape(-1)
        flat_t = jnp.repeat(jnp.arange(t), k)
        flat_g = gate.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        se, st, sg = flat_e[order], flat_t[order], flat_g[order]
        counts = jnp.bincount(se, length=e)
        starts = jnp.cumsum(counts) - counts
        rank = jnp.arange(t * k) - starts[se]
        keep = rank < cap
        dest = jnp.where(keep, se * cap + rank, e * cap)
        return {"probs": probs, "gate": gate, "idx": idx, "se": se,
                "st": st, "sg": sg, "keep": keep, "dest": dest}
    return jax.jit(route)(logits)


def test_routing_lines_are_the_references():
    source = inspect.getsource(jax_layers.moe_ffn)
    for line in ROUTING_LINES:
        assert line in source, line


def _tied_logits(g, t, e):
    """Logits with forced ties: columns 1 and e - 2 equal everywhere,
    rows 0, 4, 8, ... constant (all e experts tied), rows 1, 5, 9, ...
    with two equal maxima, in columns 0 and 3."""
    lg = g.standard_normal((t, e)).astype(np.float32)
    lg[:, e - 2] = lg[:, 1]
    lg[::4] = 0.5
    lg[1::4, 3] = lg[1::4, 0] = lg[1::4].max(axis=1) + 1.0
    return lg


@pytest.mark.parametrize("e,k,t,cf,ties", [
    (4, 2, 32, 2.0, False),       # the reduced configs' router
    (4, 2, 32, 2.0, True),
    (64, 6, 512, 1.25, False),    # deepseek-v2-lite-16b's, 4 x 128 tokens
    (64, 6, 512, 1.25, True),
    (16, 2, 96, 1.25, True),      # phi3.5-moe's, some assignments dropped
])
def test_routing_bit_for_bit(e, k, t, cf, ties):
    """From the same float32 logits: probabilities, top-k indices and
    gates, the sorted assignments, which are kept and their slots equal
    the reference's; among equal probabilities the lower index wins."""
    g = np.random.default_rng(e * 1000 + t)
    logits = (_tied_logits(g, t, e) if ties
              else (g.standard_normal((t, e)) * 3).astype(np.float32))
    cap = int(cf * t * k / e) + 1
    want = _jax_route(logits, k, cap)
    got = layers.moe_route(torch.as_tensor(logits), k, cap)
    for name in ("probs", "gate", "sg"):
        np.testing.assert_array_equal(_np(got[name]), np.asarray(want[name]),
                                      err_msg=name)
    for name in ("idx", "se", "st", "keep", "dest"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    if ties:
        idx = got["idx"].numpy()
        np.testing.assert_array_equal(idx[::4], np.arange(k)[None].repeat(
            idx[::4].shape[0], 0))
        assert (idx[1::4, :2] == [0, 3]).all()
    if cf == 1.25 and e == 16:
        assert not got["keep"].all()


# ---------------------------------------------------------------------------
# the model's loss and gradients
# ---------------------------------------------------------------------------

def _batch(cfg, seq_len=16):
    js = JaxTokenStream(vocab_size=cfg.vocab_size, seq_len=seq_len,
                        n_workers=3, per_worker_batch=2, num_codebooks=1,
                        frontend_tokens=0, d_model=cfg.d_model, seed=4)
    batch = jax.tree.map(lambda a: a[1], js.minibatch(2))
    return batch, tree_from_numpy(jax.device_get(batch))


def _loss_held(jcfg, cfg, jparams, params, loss_tol, grad_tol):
    jbatch, batch = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, jcfg, jbatch)))(jparams)
    tp = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(tp, cfg, batch)
    grads = torch.autograd.grad(loss, [tp[k] for k in sorted(tp)])
    tl, jl = float(loss.detach()), float(jl)
    assert abs(tl - jl) <= loss_tol * abs(jl), (tl, jl)
    jflat = _jax_flat(jg)
    assert sorted(tp) == list(jflat)
    for k, g in zip(sorted(tp), grads):
        _within(g, jflat[k], grad_tol, k)


@pytest.mark.parametrize("name", MOE)
def test_loss_and_grads(inits, name):
    """The LM loss (cross entropy plus the float32 aux) and every
    parameter's gradient, float32."""
    _loss_held(*inits[name], LOSS_TOL, GRAD_TOL)


def test_loss_and_grads_bf16(inits):
    """deepseek in bfloat16: the parameters are the float32 init rounded
    to bfloat16, which is the bfloat16 init of both packages."""
    jcfg, cfg, jparams, params = inits[MOE[0]]
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    params = {k: v.bfloat16() for k, v in params.items()}
    _loss_held(jcfg, cfg, jparams, params, BF16_LOSS_TOL, BF16_GRAD_TOL)
