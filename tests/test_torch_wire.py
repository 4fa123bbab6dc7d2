"""The port's sparse wire layer against ``repro.core.wire`` on the same
inputs and keys: payloads, decoding and reconstruction bit for bit, the
wire statistics to 1e-6 (scatter-adds sum in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import tree_utils as jtu
from repro.core import wire as jwire
from repro_torch.convert import key_from_numpy, tree_from_numpy
from repro_torch.core import compressors as tcomp
from repro_torch.core import tree_utils as ttu
from repro_torch.core import wire as twire

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

STATS_TOL = 1e-6
N = 5


def _case(seed, dim=40, base=True, ratio=0.1):
    rng = np.random.default_rng(seed)
    stacked = {"b": rng.standard_normal((N,)).astype(np.float32),
               "w": rng.standard_normal((N, dim)).astype(np.float32)}
    g = ({"b": rng.standard_normal(()).astype(np.float32),
          "w": rng.standard_normal((dim,)).astype(np.float32)}
         if base else None)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(seed), i))(jnp.arange(N))
    jw = jwire.pack_candidates(
        jcomp.rand_k(ratio), jkeys,
        {k: jnp.asarray(v) for k, v in stacked.items()},
        base=None if g is None else {k: jnp.asarray(v)
                                     for k, v in g.items()},
        base_shared=True)
    tw = twire.pack_candidates(
        tcomp.rand_k(ratio), key_from_numpy(jkeys), tree_from_numpy(stacked),
        base=None if g is None else tree_from_numpy(g), base_shared=True)
    return stacked, jw, tw


@pytest.mark.parametrize("dim", [40, 123, 1000])
def test_pack_candidates_payloads_bit_exact(dim):
    _, jw, tw = _case(dim, dim)
    assert tw.names == ("b", "w") and tw.n == jw.n
    assert tw.shapes == tuple(tuple(s) for s in jw.shapes)
    for jp, tp in zip(jw.payloads, tw.payloads):
        for name in ("vals", "idx"):
            np.testing.assert_array_equal(tp[name].numpy(),
                                          np.asarray(jp[name]))


@pytest.mark.parametrize("base", [True, False])
def test_decoded_payload_and_reconstruct_bit_exact(base):
    _, jw, tw = _case(1, base=base)
    for fn in ("decoded_payload", "reconstruct"):
        ref = getattr(jwire, fn)(jw)
        got = getattr(twire, fn)(tw)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_decoded_payload_equals_compress_tree():
    stacked, _, tw = _case(2)
    qkeys = key_from_numpy(jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(2), i))(jnp.arange(N)))
    dec = twire.decoded_payload(tw)
    comp = tcomp.rand_k(0.1)
    for i in range(N):
        want = ttu.compress_tree(comp, qkeys[i], {k: torch.as_tensor(v[i])
                                                  for k, v in stacked.items()})
        for k in want:
            torch.testing.assert_close(dec[k][i], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("base", [True, False])
def test_wire_stats(base):
    _, jw, tw = _case(3, base=base)
    good = np.arange(N) >= 1
    jm, js = jwire.wire_stats(jw, jnp.asarray(good))
    tm, ts = twire.wire_stats(tw, torch.as_tensor(good))
    for a, b in zip(tm + ts, jm + js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=STATS_TOL,
                                   atol=STATS_TOL)


def test_wire_stats_equal_dense_masked_mean_std():
    _, _, tw = _case(4)
    good = torch.arange(N) >= 1
    means, stds = twire.wire_stats(tw, good)
    dm, ds = ttu.masked_mean_std(twire.reconstruct(tw), good)
    for j, k in enumerate(tw.names):
        torch.testing.assert_close(means[j], dm[k].reshape(-1),
                                   rtol=STATS_TOL, atol=STATS_TOL)
        torch.testing.assert_close(stds[j], ds[k].reshape(-1),
                                   rtol=STATS_TOL, atol=STATS_TOL)


@pytest.mark.parametrize("ratio", [0.05, 0.1, 0.5])
def test_tree_wire_bits(ratio):
    stacked, _, _ = _case(5)
    ref = jwire.tree_wire_bits(jcomp.rand_k(ratio),
                               {k: jnp.asarray(v) for k, v in stacked.items()})
    got = twire.tree_wire_bits(tcomp.rand_k(ratio), tree_from_numpy(stacked))
    assert got == ref


def test_masked_mean_std_matches_reference():
    rng = np.random.default_rng(6)
    xs = {"b": rng.standard_normal((N,)).astype(np.float32),
          "w": rng.standard_normal((N, 3, 7)).astype(np.float32)}
    good = np.arange(N) >= 2
    jm, js = jtu.masked_mean_std({k: jnp.asarray(v) for k, v in xs.items()},
                                 jnp.asarray(good))
    tm, ts = ttu.masked_mean_std(tree_from_numpy(xs), torch.as_tensor(good))
    for k in xs:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=STATS_TOL, atol=STATS_TOL)
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=STATS_TOL, atol=STATS_TOL)
