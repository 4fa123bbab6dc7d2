"""repro_torch.random against jax.random: integer draws bit for bit,
normals bit for bit (their erfinv in XLA's own log1p, ``xla_math``) and,
as the first bound they were held to, within a stated ulp bound."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_logreg_data as jax_make_logreg_data
from repro_torch import random as R
from repro_torch.convert import key_from_numpy
from repro_torch.data.synthetic import make_logreg_data

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

# float32 erfinv through Giles' polynomial: the port evaluates each Horner
# step as one rounding of an exact product plus a sum, as XLA's fused
# multiply-adds do; the sqrt(2)·erfinv(u) chain then differs by at most a
# few units in the last place.
NORMAL_ULP = 4


def _key(seed=7):
    return jax.random.PRNGKey(seed), R.PRNGKey(seed)


def _same(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a).astype(
        t.numpy().dtype))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_prng_key(seed):
    _same(R.PRNGKey(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("num", [2, 3, 4, 5])
def test_split(num):
    jk, tk = _key()
    _same(R.split(tk, num), jax.random.split(jk, num))


@pytest.mark.parametrize("data", [0, 1, 6, 2 ** 31 - 1])
def test_fold_in(data):
    jk, tk = _key(3)
    _same(R.fold_in(tk, data), jax.random.fold_in(jk, data))


def test_fold_in_batched_matches_vmap():
    jk, tk = _key(11)
    ref = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.arange(6))
    _same(R.fold_in(tk, torch.arange(6)), ref)


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (4096,)])
def test_random_bits(shape):
    jk, tk = _key()
    _same(R.random_bits(tk, shape), jax.random.bits(jk, shape, jnp.uint32))


def test_uniform():
    jk, tk = _key(5)
    _same(R.uniform(tk, (3, 333)), jax.random.uniform(jk, (3, 333)))
    _same(R.uniform(tk, (50,), -1.0, 1.0),
          jax.random.uniform(jk, (50,), minval=-1.0, maxval=1.0))


@pytest.mark.parametrize("p", [0.1, 0.3, 0.4])
def test_bernoulli(p):
    jk, tk = _key(9)
    _same(R.bernoulli(tk, p, (2000,)), jax.random.bernoulli(jk, p, (2000,)))
    assert bool(R.bernoulli(tk, p)) == bool(jax.random.bernoulli(jk, p))


@pytest.mark.parametrize("span", [1, 7, 400, 32561])
def test_randint(span):
    jk, tk = _key(13)
    _same(R.randint(tk, (5, 32), 0, span),
          jax.random.randint(jk, (5, 32), 0, span))


@pytest.mark.parametrize("n", [1, 5, 64, 1000, 5000])
def test_permutation(n):
    jk, tk = _key(17)
    _same(R.permutation(tk, n), jax.random.permutation(jk, n))


def test_permutation_batched_keys():
    jk, tk = _key(19)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.arange(5))
    ref = jax.vmap(lambda k: jax.random.permutation(k, 123))(jkeys)
    _same(R.permutation(key_from_numpy(jkeys), 123), ref)


def test_normal_within_ulp_bound():
    jk, tk = _key(23)
    got = R.normal(tk, (20000,)).numpy()
    ref = np.asarray(jax.random.normal(jk, (20000,)))
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - ref.view(np.int32).astype(np.int64))
    assert ulp.max() <= NORMAL_ULP
    assert (ulp == 0).mean() > 0.95


@pytest.mark.parametrize("seed", [23, 0])
def test_normal_bit_for_bit(seed):
    jk, tk = _key(seed)
    got = R.normal(tk, (20000,)).numpy()
    ref = np.asarray(jax.random.normal(jk, (20000,)))
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("shape", [(333, 61), (4096,)])
def test_normal_drawn_in_blocks_bit_for_bit(monkeypatch, shape):
    """A draw larger than ``DRAW_BLOCK`` (here a few hundred elements, a
    last block short or full) hashes its counters block by block and
    equals JAX's normal of the whole shape."""
    monkeypatch.setattr(R, "DRAW_BLOCK", [512])
    jk, tk = _key(7)
    got = R.normal(tk, shape).numpy()
    ref = np.asarray(jax.random.normal(jk, shape))
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def test_logreg_features_bit_for_bit_at_a9a_width():
    """The synthetic data at the paper's a9a width (32561 x 123), features
    and labels equal to the reference's."""
    kw = dict(n_samples=32561, dim=123, n_workers=5)
    ref = jax_make_logreg_data(jax.random.PRNGKey(0), **kw)
    got = make_logreg_data(R.PRNGKey(0), **kw)
    assert np.array_equal(got.features.numpy(), np.asarray(ref.features))
    assert np.array_equal(got.labels.numpy(), np.asarray(ref.labels))


def test_logreg_data_features_and_labels():
    """The synthetic data the trajectory tests make on each side: features
    within the normal ulp bound, labels identical."""
    kw = dict(n_samples=200, dim=40, n_workers=5)
    ref = jax_make_logreg_data(jax.random.PRNGKey(0), **kw)
    got = make_logreg_data(R.PRNGKey(0), **kw)
    f_ref = np.asarray(ref.features)
    f_got = got.features.numpy()
    assert ((f_ref == 0) == (f_got == 0)).all()
    ulp = np.abs(f_got.view(np.int32).astype(np.int64)
                 - f_ref.view(np.int32).astype(np.int64))
    assert ulp.max() <= NORMAL_ULP
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
