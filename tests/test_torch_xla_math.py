"""repro_torch.xla_math and the logistic loss against the reference's
compiled code on the CPU: XLA's own log, log1p and exp bit for bit (libm
differs from them by an ulp on a few percent of inputs), softplus and its
derivative bit for bit, the gradient's column-major product in the order
``aggregators.weighted_rows`` repeats, and the per-worker gradients of
``engine.stacked_grads`` within a few ulps: the op the port cannot repeat
is the logits' dot product, which XLA emits as a loop fusion whose
reduction LLVM reassociates by d and the host's vector width (ROADMAP
queue 3); the loss takes PyTorch's products for both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import stacked_grads as jax_stacked_grads
from repro.data.synthetic import logreg_loss as jax_logreg_loss
from repro_torch import random as R
from repro_torch import xla_math as X
from repro_torch.core.aggregators import weighted_rows, xla_sum_lanes
from repro_torch.core.engine import stacked_grads
from repro_torch.data.synthetic import (logreg_loss, xla_softplus,
                                        xla_softplus_cotangent)

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

# the loss's gradient through torch.matmul's products: the logits part from
# XLA's by an ulp or two, and the gradient by as much times the batch's
# largest feature
GRAD_ULP_TOL = 1e-6


def _bits_equal(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    same = (got.view(np.int32) == ref.view(np.int32)) | (
        np.isnan(got) & np.isnan(ref))
    return int((~same).sum())


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = {"log": (1e-30, 1e4), "log1p": (-0.999, 50.0),
              "exp": (-95.0, 95.0), "expm1": (-95.0, 95.0),
              "tanh": (-30.0, 30.0)}[name]
    x = np.concatenate([rng.uniform(lo, hi, 100_000),
                        rng.uniform(-0.5, 0.5, 50_000),
                        np.exp(rng.uniform(-80, 80, 50_000)),
                        [0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan,
                         1e-40, -1e-40]])
    return x.astype(np.float32)


@pytest.mark.parametrize("name", ["log", "log1p", "exp", "expm1", "tanh"])
def test_xla_math_bit_for_bit(name):
    x = _inputs(name)
    with np.errstate(all="ignore"):
        ref = np.asarray(jax.jit(getattr(jnp, name))(x))
    got = getattr(X, name)(torch.from_numpy(x)).numpy()
    assert _bits_equal(got, ref) == 0


# jnp.linspace's lengths: every one through the unrolled range and past
# it, the SSD's and RG-LRU's at reduced and published widths (8, 24; 128,
# 2560), and block and unroll edges
LINSPACE_NUMS = (list(range(0, 70)) + [127, 128, 129, 351, 352, 353, 354,
                                       383, 384, 385, 1000, 2559, 2560,
                                       4096])


@pytest.mark.parametrize("start,stop", [(1.0, 16.0), (0.9, 0.999),
                                        (-3.0, 7.5)])
def test_linspace_bit_for_bit(start, stop):
    """``xla_math.linspace`` against ``jnp.linspace`` (which is jitted):
    the unrolled loop's folded constants, the vectorized loop's fused
    ones and the remainder past its last block."""
    for num in LINSPACE_NUMS:
        want = np.asarray(jnp.linspace(start, stop, num))
        got = X.linspace(start, stop, num).numpy()
        assert got.shape == want.shape, num
        assert _bits_equal(got, want) == 0, num


@pytest.mark.parametrize("n", [7, 16, 17, 64, 100, 300])
def test_cumsum_bit_for_bit(n):
    """``xla_math.cumsum`` against the jitted ``jnp.cumsum`` (blocks of
    16, the blocks' totals summed the same way, one level or two); the
    SSD's log decays difference its running sums. ``torch.cumsum``
    accumulates in float64 on the CPU and parts from it."""
    x = (np.random.default_rng(n).standard_normal((3, n, 5)) * 0.3
         - 0.1).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=1))(x))
    got = X.cumsum(torch.from_numpy(x), 1).numpy()
    assert _bits_equal(got, want) == 0
    if n > 16:
        assert _bits_equal(torch.cumsum(torch.from_numpy(x), 1).numpy(),
                           want) > 0


def test_libm_differs_where_xla_math_does_not():
    """The repair is needed: PyTorch's log1p parts from XLA's on a share
    of inputs; xla_math's on none."""
    x = np.random.default_rng(1).uniform(-0.9, 3.0, 200_000).astype(
        np.float32)
    ref = np.asarray(jax.jit(jnp.log1p)(x))
    assert _bits_equal(torch.log1p(torch.from_numpy(x)).numpy(), ref) > 0
    assert _bits_equal(X.log1p(torch.from_numpy(x)).numpy(), ref) == 0


@pytest.mark.parametrize("scale", [0.1, 1.0, 8.0, 60.0])
def test_softplus_and_its_cotangent_bit_for_bit(scale):
    rng = np.random.default_rng(int(scale * 10))
    logits = (rng.standard_normal((5, 32)) * scale).astype(np.float32)
    logits[0, :4] = [np.inf, -np.inf, 120.0, -120.0]
    y = (rng.random(logits.shape) > 0.5).astype(np.float32)
    sp = xla_softplus(torch.from_numpy(logits))
    assert _bits_equal(sp.numpy(), jax.jit(jax.nn.softplus)(logits)) == 0
    grad = jax.jit(jax.vmap(jax.grad(
        lambda l, t: jnp.mean(jax.nn.softplus(l) - t * l))))
    got = xla_softplus_cotangent(torch.from_numpy(logits), sp,
                                 torch.from_numpy(y),
                                 torch.tensor(1.0 / logits.shape[1]))
    assert _bits_equal(got.numpy(), grad(logits, y)) == 0


def _grad_inputs(seed, dim=123, batch=32):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(dim) * (0.1 + seed)).astype(np.float32)
    b = np.float32(0.3 * seed)
    x = (rng.standard_normal((5, batch, dim))
         * (rng.random((5, batch, dim)) < 0.4)).astype(np.float32)
    y = (rng.random((5, batch)) > 0.5).astype(np.float32)
    return w, b, x, y


def _reference_grads(w, b, x, y):
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    f = jax.jit(lambda p, bt, k: jax_stacked_grads(jax_logreg_loss(), p, bt,
                                                   k))
    loss, g = f({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                {"x": jnp.asarray(x), "y": jnp.asarray(y)}, keys)
    return float(loss), {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gradient_from_the_reference_logits_bit_for_bit(seed):
    """Given the logits the reference computes, every later op of the
    gradient is the reference's: softplus's derivative, the weights'
    column-major product (one fused multiply-add a row in row order) plus
    2·(0.01·w), the bias' sum over the batch."""
    w, b, x, y = _grad_inputs(seed)
    _, ref = _reference_grads(w, b, x, y)
    logits = np.array(jax.jit(
        lambda a, v, c: jnp.einsum("wbd,d->wb", a, v) + c)(x, w, b))
    lt = torch.from_numpy(logits)
    g_l = xla_softplus_cotangent(lt, xla_softplus(lt), torch.from_numpy(y),
                                 torch.tensor(1.0 / y.shape[1]))
    wt = torch.from_numpy(w)
    reg = wt * 0.01
    gw = torch.stack([weighted_rows(g_l[i], torch.from_numpy(x[i]))
                      for i in range(5)]) + (reg + reg)
    gb = xla_sum_lanes(g_l)
    assert _bits_equal(gw.numpy(), ref["w"]) == 0
    assert _bits_equal(gb.numpy(), ref["b"]) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stacked_grads_against_the_reference(seed):
    """``engine.stacked_grads`` of the logistic loss on the CPU against the
    reference's ``jax.jit`` one: the loss to float32 rounding, the
    gradients to GRAD_ULP_TOL (the two dot products are PyTorch's)."""
    w, b, x, y = _grad_inputs(seed)
    loss_ref, ref = _reference_grads(w, b, x, y)
    loss, got = stacked_grads(
        logreg_loss(), {"w": torch.from_numpy(w), "b": torch.tensor(b)},
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        R.split(R.PRNGKey(0), 5))
    assert abs(float(loss) - loss_ref) <= 1e-6 * max(1.0, abs(loss_ref))
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0,
                                   atol=GRAD_ULP_TOL)
