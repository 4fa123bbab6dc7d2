"""The Mamba2 SSD and RG-LRU blocks (``repro_torch.models``) against the
reference package on the CPU, on mamba2-130m (tied embeddings, no FFN)
and recurrentgemma-2b (two RG-LRU blocks and one sliding-window block a
group), both ``reduced()``, and recurrentgemma-2b at 5 layers (one group
and a tail of two RG-LRU blocks, which ``reduced()``'s 3 layers lack).

Tolerances: the init equals the reference's eager init (what
``repro.api.run`` draws) bit for bit, the SSD's ``a_log`` and the
RG-LRU's ``lam`` included (XLA's float32 linspace, log and expm1, in
``xla_math``). The causal conv and the RG-LRU's linear scan equal the
jitted reference bit for bit on the same inputs (each tap's product and
the scan's a₂·b₁ + b₂ fused as XLA fuses them; the scan in
``lax.associative_scan``'s rounding tree), and so does the SSD's chunk
cumsum (``tests/test_torch_xla_math.py``). Everything else is held to
the reference under ``jax.jit``: XLA's CPU dots sum in another order
than torch's, so a layer's output
and each gradient agree to LAYER_TOL / GRAD_TOL of their largest entry,
the loss to LOSS_TOL relative, and in bfloat16 the loss to BF16_LOSS_TOL
relative and the gradients to BF16_GRAD_TOL of each leaf's largest entry
(the LM tolerances of ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses

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

MAMBA, RG = "mamba2-130m", "recurrentgemma-2b"
# name -> (arch, layers; None keeps reduced()'s)
CONFIGS = {MAMBA: (MAMBA, None), RG: (RG, None), "rg-5l": (RG, 5)}
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


def _configs(name):
    arch, n_layers = CONFIGS[name]
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=n_layers)
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    return jcfg, cfg


@pytest.fixture(scope="module")
def inits():
    """{name: (jax config, port config, reference params, port params)},
    both drawn from key 1: the reference eagerly, as its runner draws."""
    out = {}
    for name in CONFIGS:
        jcfg, cfg = _configs(name)
        out[name] = (jcfg, cfg, jax_init(jax.random.PRNGKey(1), jcfg),
                     init_params(R.PRNGKey(1), cfg))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_bit_for_bit(inits, name):
    """Every leaf in the reference's order: the SSD's 6-way and the
    RG-LRU's 7-way splits, no norm2 or FFN in a Mamba2 block, no unembed
    under tied embeddings, the 5-layer stack's tail."""
    _, cfg, jparams, params = inits[name]
    want = _jax_flat(jparams)
    assert list(params) == list(want)
    for k, v in params.items():
        assert v.dtype == cfg.torch_dtype
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                      err_msg=k)
    if name == MAMBA:
        assert "unembed" not in params
        assert not any("ffn/" in k or "norm2" in k for k in params)
    if name == "rg-5l":
        assert {k.split("/")[1] for k in params if k.startswith("tail/")} \
            == {"0", "1"}


@pytest.mark.parametrize("nh,w", [(8, 128), (24, 2560)])
def test_init_constants_bit_for_bit_where_plain_torch_is_not(nh, w):
    """``a_log`` and ``lam`` at the reduced and the published widths equal
    the reference's eager constants; torch's own linspace, log and expm1
    part from them (the reason the port repeats XLA's arithmetic)."""
    a_log = jnp.log(jnp.linspace(1.0, 16.0, nh))
    lam = jnp.log(jnp.expm1(-jnp.log(jnp.linspace(0.9, 0.999, w)) / 8.0))
    np.testing.assert_array_equal(layers.ssd_a_log(nh).numpy(),
                                  np.asarray(a_log))
    np.testing.assert_array_equal(layers.rglru_lambda(w).numpy(),
                                  np.asarray(lam))
    plain = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, w)) / 8.0))
    assert (plain.numpy() != np.asarray(lam)).any()


# ---------------------------------------------------------------------------
# the layers on numpy inputs
# ---------------------------------------------------------------------------

def _params(shapes: dict, seed: int) -> dict:
    """numpy parameters: matrices normal / sqrt(fan_in), vectors small
    (``a_log`` and ``lam`` near their inits' ranges)."""
    g = np.random.default_rng(seed)
    out = {}
    for k, s in shapes.items():
        scale = 0.1 if len(s) == 1 else 1.0 / np.sqrt(s[-2])
        out[k] = (g.standard_normal(s) * scale).astype(np.float32)
    if "a_log" in out:
        nh = shapes["a_log"][0]
        out["a_log"] = np.log(np.linspace(1, 16, nh)).astype(np.float32)
    if "lam" in out:
        out["lam"] = (out["lam"] + 3.0).astype(np.float32)
    return out


def _nest(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return out


def _held_layer(jax_fn, port_fn, params, x, probe):
    """The layer's output and the gradients of Σ y·probe with respect to
    every parameter and the input, the reference jitted."""
    def jax_obj(p, xx):
        y = jax_fn(p, xx)
        return jnp.sum(y * probe), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True))(_nest(params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    y = port_fn(tp, tx)
    keys = sorted(tp)
    grads = torch.autograd.grad((y * torch.as_tensor(probe)).sum(),
                                [tp[k] for k in keys] + [tx])
    _within(y, jy, LAYER_TOL, "y")
    jflat = _jax_flat(jgp)
    for k, g in zip(keys, grads):
        _within(g, jflat[k], GRAD_TOL, k)
    _within(grads[-1], jgx, GRAD_TOL, "x")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_bit_for_bit(dtype):
    """The width-4 filter on (2, 37, 24): the jitted reference fuses taps
    1 to 3 into their sums (first tap's product into the second's); in
    bfloat16 every product is exact, so the plain sum is the same."""
    g = np.random.default_rng(3)
    x = g.standard_normal((2, 37, 24)).astype(np.float32)
    w = g.standard_normal((4, 24)).astype(np.float32)
    jt = getattr(jnp, dtype)
    want = jax.jit(jax_layers.causal_conv1d)(jnp.asarray(x, jt),
                                             jnp.asarray(w, jt))
    tt = getattr(torch, dtype)
    got = layers.causal_conv1d(torch.from_numpy(x).to(tt),
                               torch.from_numpy(w).to(tt))
    assert got.dtype == tt
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(want.astype(jnp.float32)))


def _ssd_float64(xh, bm, cm, dt, a_log):
    """The recurrence the SSD computes, step by step in float64:
    h_t = exp(dt_t·A) h_{t-1} + dt_t · B_t ⊗ x_t, y_t = C_t · h_t."""
    a = -torch.exp(a_log)
    state = torch.zeros(xh.shape[:1] + (xh.shape[2], bm.shape[-1],
                                        xh.shape[3]), dtype=torch.float64)
    ys = []
    for t in range(xh.shape[1]):
        state = (state * torch.exp(dt[:, t] * a)[..., None, None]
                 + (dt[:, t, :, None, None] * bm[:, t, None, :, None]
                    * xh[:, t, :, None, :]))
        ys.append(torch.einsum("bn,bhnp->bhp", cm[:, t], state))
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("chunk", [64, 32, 16])
def test_ssd_chunked_against_the_reference(chunk):
    """y and the final state of the chunked SSD over 64 steps in 1, 2 and
    4 chunks (the states passed on from chunk to chunk), at the decays of
    the inits (A from 1 to 16, dt a softplus), and the gradients of both
    through the log-space mask. A_log's gradient sums the whole
    sequence's cancelling log-decay terms: the reference itself parts
    from the recurrence in float64 (``_ssd_float64``) by more than
    GRAD_TOL (2.4e-5 of its largest entry in one chunk of 64, 4.3e-5 in
    two of 32), so it is held to the reference within GRAD_TOL or,
    failing that, to the float64 recurrence within the reference's own
    distance from it (3.1e-5 in two chunks of 32)."""
    g = np.random.default_rng(chunk)
    b, t, h, p, n = 2, 64, 4, 8, 16
    xh = g.standard_normal((b, t, h, p)).astype(np.float32)
    bm = g.standard_normal((b, t, n)).astype(np.float32)
    cm = g.standard_normal((b, t, n)).astype(np.float32)
    dt = np.log1p(np.exp(g.standard_normal((b, t, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1, 16, h)).astype(np.float32)
    py = g.standard_normal((b, t, h, p)).astype(np.float32)
    ps = g.standard_normal((b, h, n, p)).astype(np.float32)
    inputs = (xh, bm, cm, dt, a_log)

    def jax_obj(args):
        y, s = jax_layers._ssd_chunked(*args, chunk=chunk)
        return jnp.sum(y * py) + jnp.sum(s * ps), (y, s)

    (_, (jy, js)), jg = jax.jit(jax.value_and_grad(jax_obj, has_aux=True))(
        tuple(jnp.asarray(a) for a in inputs))
    targs = [torch.tensor(a, requires_grad=True) for a in inputs]
    y, s = layers._ssd_chunked(*targs, chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    _within(y, jy, LAYER_TOL, "y")
    _within(s, js, LAYER_TOL, "final state")
    grads = torch.autograd.grad((y * torch.as_tensor(py)).sum()
                                + (s * torch.as_tensor(ps)).sum(), targs)
    args64 = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in inputs]
    y64, s64 = _ssd_float64(*args64)
    _within(y, y64.detach(), LAYER_TOL, "y against the float64 recurrence")
    true = torch.autograd.grad((y64 * torch.as_tensor(py)).sum()
                               + (s64 * torch.as_tensor(ps)).sum(), args64)
    for name, got, want, exact in zip(("xh", "b", "c", "dt", "a_log"),
                                      grads, jg, true):
        assert torch.isfinite(got).all(), name
        got, want, exact = _np(got), np.asarray(want), exact.numpy()
        scale = np.abs(exact).max()
        if np.abs(got - want).max() <= GRAD_TOL * scale:
            continue
        assert name == "a_log", name
        ref_err = np.abs(want - exact).max()
        assert ref_err > GRAD_TOL * scale, name
        assert np.abs(got - exact).max() <= ref_err, name


@pytest.mark.parametrize("t,chunk", [(16, 64), (16, 8)])
def test_mamba2_block_against_the_reference(t, chunk):
    """The whole SSD block at reduced width, in one chunk and in two."""
    jcfg, cfg = _configs(MAMBA)
    params = _params(layers.mamba2_shapes(cfg), 21)
    g = np.random.default_rng(22)
    x = g.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    probe = g.standard_normal(x.shape).astype(np.float32)
    _held_layer(
        lambda p, xx: jax_layers.mamba2_block(p, jcfg, xx, chunk=chunk),
        lambda p, xx: layers.mamba2_block(p, cfg, xx, chunk=chunk),
        params, x, probe)


def test_rglru_gates_against_the_reference():
    """a and the gated input, and their gradients (sigmoid, softplus, exp
    and the clipped root in float32)."""
    _, cfg = _configs(RG)
    params = _params(layers.rglru_shapes(cfg), 31)
    gate_params = {k: params[k] for k in ("w_a", "b_a", "w_i", "b_i",
                                          "lam")}
    g = np.random.default_rng(32)
    u = g.standard_normal((2, 7, cfg.rglru_width)).astype(np.float32)
    pa, pg = (g.standard_normal(u.shape).astype(np.float32)
              for _ in range(2))
    _held_layer(
        lambda p, uu: (lambda a, b: a * pa + b * pg)(
            *jax_layers._rglru_gates(p, uu)),
        lambda p, uu: (lambda a, b: a * torch.as_tensor(pa)
                       + b * torch.as_tensor(pg))(
            *layers._rglru_gates(p, uu)),
        gate_params, u, np.ones_like(u))


@pytest.mark.parametrize("t", [1, 2, 7, 128])
def test_linear_scan_bit_for_bit(t):
    """h from ``lax.associative_scan`` under ``jax.jit`` (odd lengths
    reach its odd branch), and from the port's strided recursion."""
    g = np.random.default_rng(t)
    a = g.uniform(0.5, 1.0, (2, t, 24)).astype(np.float32)
    b = g.standard_normal((2, t, 24)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    want = jax.jit(lambda a, b: lax.associative_scan(
        combine, (a, b), axis=1))(a, b)
    got = layers._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    for w, v in zip(want, got):
        np.testing.assert_array_equal(v.numpy(), np.asarray(w))


@pytest.mark.parametrize("t", [1, 7, 128])
def test_rglru_block_against_the_reference(t):
    """The whole recurrent block: the tanh gelu, the conv, the gates, the
    scan and the gate product, output and gradients."""
    jcfg, cfg = _configs(RG)
    params = _params(layers.rglru_shapes(cfg), 41)
    g = np.random.default_rng(42)
    x = g.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    probe = g.standard_normal(x.shape).astype(np.float32)
    _held_layer(lambda p, xx: jax_layers.rglru_block(p, jcfg, xx),
                lambda p, xx: layers.rglru_block(p, cfg, xx),
                params, x, probe)


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


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_grads(inits, name):
    """The LM loss and every parameter's gradient, float32; mamba2-130m's
    ``embed`` gradient sums the lookup's and the tied head's."""
    _loss_held(*inits[name], LOSS_TOL, GRAD_TOL)


@pytest.mark.parametrize("name", [MAMBA, RG])
def test_loss_and_grads_bf16(inits, name):
    """bfloat16: the parameters are the float32 init rounded to bfloat16,
    which is the bfloat16 init of both packages."""
    jcfg, cfg, jparams, params = inits[name]
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    params = {k: v.bfloat16() for k, v in params.items()}
    _loss_held(jcfg, cfg, jparams, params, BF16_LOSS_TOL, BF16_GRAD_TOL)
