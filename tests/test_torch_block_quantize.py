"""The port's block quantizer against the reference, bit for bit.

``block_quantize_plain`` (and the entry point on CPU tensors) is held to
``repro.kernels.quantize.block_quantize`` run in interpret mode, and the
port's oracle ``ref.block_quantize_ref`` to the reference's, on the same
numpy inputs. floor() turns a one-ulp difference in a block's norm into a
whole level, so nothing short of bit equality would do, and none is
needed: both take the norms as XLA does on the CPU (rounded squares, eight
windows of 32 lanes, a correctly rounded square root). Not a single level
differs at any tested shape. At levels = 3 the reference's compiled kernel
multiplies by the rounded 1/3 where its oracle divides by 3; the plain
version follows the kernel and the port's oracle the reference's oracle,
each bit for bit. The CUDA kernel is held to the plain version on the card
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quantize as jq
from repro.kernels import ref as jref
from repro_torch.convert import key_from_numpy
from repro_torch.kernels import ops, quantize, ref

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)


def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    # heavy-tailed magnitudes spread the norms over many binades
    x = (rng.standard_normal(d) * rng.exponential(1.0, d)).astype(np.float32)
    x[rng.random(d) < 0.05] = 0.0
    u = rng.random(d).astype(np.float32)
    return x, u


@pytest.mark.parametrize("levels", [1, 4, 16])
@pytest.mark.parametrize("d", [1000, 2048, 5000, 70000])
def test_block_quantize_matches_reference(d, levels):
    x, u = _inputs(d, d + levels)
    want = np.asarray(jq.block_quantize(jnp.asarray(x), jnp.asarray(u),
                                        levels=levels, interpret=True))
    want_ref = np.asarray(jref.block_quantize_ref(
        jnp.asarray(x), jnp.asarray(u), levels=levels, block=256))
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    got = quantize.block_quantize(tx, tu, levels=levels)
    assert got.dtype == torch.float32 and got.shape == (d,)
    flips = int(np.sum(quantize.block_quantize_plain(tx, tu, levels=levels)
                       .numpy() != want))
    assert flips == 0
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.block_quantize_ref(tx, tu, levels=levels, block=256).numpy(),
        want_ref)
    assert quantize.block_quantize.launches == 0        # plain on the CPU


def test_division_by_levels_follows_each_reference_function():
    """levels = 3: the compiled kernel takes ·(1/3), the oracle /3."""
    x, u = _inputs(5000, 3)
    kern = np.asarray(jq.block_quantize(jnp.asarray(x), jnp.asarray(u),
                                        levels=3, interpret=True))
    orac = np.asarray(jref.block_quantize_ref(jnp.asarray(x), jnp.asarray(u),
                                              levels=3, block=256))
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_array_equal(
        quantize.block_quantize_plain(tx, tu, levels=3).numpy(), kern)
    np.testing.assert_array_equal(
        ref.block_quantize_ref(tx, tu, levels=3, block=256).numpy(), orac)
    assert np.any(kern != orac)


@pytest.mark.parametrize("block", [32, 100, 256])
def test_block_quantize_ref_other_blocks(block):
    x, u = _inputs(3000, block)
    want = np.asarray(jref.block_quantize_ref(jnp.asarray(x), jnp.asarray(u),
                                              levels=4, block=block))
    got = ref.block_quantize_ref(torch.as_tensor(x), torch.as_tensor(u),
                                 levels=4, block=block)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [1, 300, 4096])
def test_ops_block_quantize_draws_the_reference_dither(d):
    x, _ = _inputs(d, 9)
    key = jax.random.PRNGKey(d)
    want = np.asarray(jops.block_quantize(jnp.asarray(x), key, levels=4))
    got = ops.block_quantize(torch.as_tensor(x), key_from_numpy(key),
                             levels=4)
    np.testing.assert_array_equal(got.numpy(), want)
    u = jax.random.uniform(key, (d,))
    np.testing.assert_array_equal(
        ops.block_quantize_oracle(torch.as_tensor(x),
                                  torch.as_tensor(np.array(u))).numpy(),
        np.asarray(jops.block_quantize_oracle(jnp.asarray(x), u)))


def test_zero_blocks_quantize_to_zero():
    x = np.zeros(600, np.float32)
    x[300] = 2.0
    u = np.full(600, 0.5, np.float32)
    got = quantize.block_quantize(torch.as_tensor(x), torch.as_tensor(u))
    assert got.abs().sum() == 2.0 and got[300] == 2.0
