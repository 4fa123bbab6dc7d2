"""The port's kernel entry points (``repro_torch.kernels.ops``) against
``repro.kernels.ops`` on the same numpy inputs and the same key, carried
across by ``convert.key_from_numpy``; the reference's kernels run in
interpret mode, the port's entry points on CPU tensors take the plain
versions. Tolerances as in ROADMAP.md: the coordinate rules bit for bit
where no bucket operator W is applied and to 1e-6 where one is (W @ x
sums in another order), RFA and Krum to 2e-5 (the reference's
pallas≡gspmd tolerance); the oracles of ``kernels/ref`` likewise, and the
pairwise squared distances to 1e-5 of the largest entry (sums over d in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import wire as jwire
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import key_from_numpy, tree_from_numpy
from repro_torch.core import compressors as tcomp
from repro_torch.core import wire as twire
from repro_torch.kernels import ops, ref

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

W_TOL = 1e-6           # through W, in another order
NORM_TOL = 2e-5        # RFA / Krum: the reference's pallas≡gspmd tolerance
D = 300


def _stack(n, seed=0, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _close(got, want, tol):
    if tol == 0:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("rule", ["median", "mean", "trimmed"])
@pytest.mark.parametrize("n", [5, 64, 65])
def test_robust_agg(n, rule, s):
    x = _stack(n, n)
    key = jax.random.PRNGKey(n + s)
    want = jops.robust_agg(jnp.asarray(x), key, bucket_size=s, rule=rule)
    got = ops.robust_agg(torch.as_tensor(x), key_from_numpy(key),
                         bucket_size=s, rule=rule)
    # W applies when s > 1 at n <= 64; above, both bucket first, exactly
    _close(got, want, W_TOL if s > 1 and n <= 64 else 0)


@pytest.mark.parametrize("rule", ["median", "trimmed"])
def test_robust_agg_without_a_key_buckets_in_order(rule):
    x = _stack(7, 1)
    want = jops.robust_agg(jnp.asarray(x), None, bucket_size=2, rule=rule)
    got = ops.robust_agg(torch.as_tensor(x), None, bucket_size=2, rule=rule)
    _close(got, want, W_TOL)


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("n", [5, 64, 65])
def test_rfa_agg(n, s):
    x = _stack(n, n + 1)
    key = jax.random.PRNGKey(n)
    want = jops.rfa_agg(jnp.asarray(x), key, bucket_size=s)
    got = ops.rfa_agg(torch.as_tensor(x), key_from_numpy(key), bucket_size=s)
    _close(got, want, NORM_TOL)


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("n", [5, 64, 65])
def test_krum_agg(n, s):
    x = _stack(n, n + 2)
    key = jax.random.PRNGKey(n)
    want = jops.krum_agg(jnp.asarray(x), key, bucket_size=s, n_byz=1)
    got = ops.krum_agg(torch.as_tensor(x), key_from_numpy(key),
                       bucket_size=s, n_byz=1)
    _close(got, want, NORM_TOL)


def _wire(kind, n=8, d=D):
    """One worker-stacked payload packed by both packages: RandK with a
    shared (1-row) base, or TopK with a per-worker (n-row) base."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    rows = 1 if kind == "randk" else n
    base = rng.standard_normal((rows, d)).astype(np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(1), i))(
        jnp.arange(n))
    jc, tc = ((jcomp.rand_k(0.1), tcomp.rand_k(0.1)) if kind == "randk"
              else (jcomp.top_k(0.1), tcomp.top_k(0.1)))
    shared = rows == 1
    jw = jwire.pack_candidates(jc, keys, {"x": jnp.asarray(x)},
                               base={"x": jnp.asarray(base[0] if shared
                                                      else base)},
                               base_shared=shared)
    tw = twire.pack_candidates(tc, key_from_numpy(keys),
                               tree_from_numpy({"x": x}),
                               base=tree_from_numpy({"x": base[0] if shared
                                                     else base}),
                               base_shared=shared)
    return jwire.wire_srcs(jw)[0], twire.wire_srcs(tw)[0]


@pytest.mark.parametrize("rule", ["median", "mean", "trimmed", "rfa", "krum"])
@pytest.mark.parametrize("kind", ["randk", "topk"])
def test_wire_agg(kind, rule):
    jsrc, tsrc = _wire(kind)
    key = jax.random.PRNGKey(5)
    want = jops.wire_agg(jsrc, key, bucket_size=2, rule=rule)
    got = ops.wire_agg(tsrc, key_from_numpy(key), bucket_size=2, rule=rule)
    _close(got, want, NORM_TOL if rule in ("rfa", "krum") else W_TOL)


@pytest.mark.parametrize("s", [0, 2, 3])
@pytest.mark.parametrize("rule", ["median", "mean", "trimmed"])
def test_robust_agg_oracle(rule, s):
    x = _stack(7, 3)
    want = jops.robust_agg_oracle(jnp.asarray(x), bucket_size=s, rule=rule)
    got = ops.robust_agg_oracle(torch.as_tensor(x), bucket_size=s, rule=rule)
    _close(got, want, 0)


@pytest.mark.parametrize("n", [5, 9])
def test_norm_oracles(n):
    x = _stack(n, 4)
    _close(ops.rfa_oracle(torch.as_tensor(x)), jops.rfa_oracle(jnp.asarray(x)),
           NORM_TOL)
    _close(ops.krum_oracle(torch.as_tensor(x), n_byz=1),
           jops.krum_oracle(jnp.asarray(x), n_byz=1), 0)
    want = np.asarray(jref.pair_sqdists_ref(jnp.asarray(x)))
    # sums over d in another order: 1e-5 of the largest entry
    np.testing.assert_allclose(ref.pair_sqdists_ref(torch.as_tensor(x)),
                               want, rtol=0, atol=1e-5 * want.max())
