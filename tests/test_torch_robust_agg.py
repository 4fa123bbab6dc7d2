"""The port's robust-aggregation kernel module against the reference.

``robust_agg_plain`` (the plain PyTorch version the CPU path takes) is held
to ``repro.kernels.robust_agg.robust_agg`` run in interpret mode on the
same numpy inputs: bit for bit where no bucket operator is applied, and to
1e-6 relative where W is (W @ x sums in another order). The CUDA kernel
itself is held to the plain version on the card by
``tests/test_torch_gpu.py`` and by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core.attacks import CoordAttack as JCoordAttack
from repro.kernels import norm_agg as jnorm
from repro.kernels import quantize as jq
from repro.kernels.robust_agg import robust_agg as jax_robust_agg
from repro_torch import random as R
from repro_torch.core import aggregators as tagg
from repro_torch.core.attacks import CoordAttack
from repro_torch.kernels import norm_agg, quantize
from repro_torch.kernels.robust_agg import robust_agg, robust_agg_plain

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

W_RTOL = 1e-6          # W @ x: float32 sums in another order
ATTACK_PARAM = {"BF": 0.0, "ALIE": 1.06, "IPM": 0.1}


def _inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    mean = rng.standard_normal(d).astype(np.float32)
    std = np.abs(rng.standard_normal(d)).astype(np.float32)
    mask = np.arange(n) < max(1, n // 4)
    return x, mean, std, mask


def _w(n, s, seed=0):
    """The reference's and the port's bucket operators for one
    permutation; the port's is held bit-exact to the reference's."""
    if not s:
        return None, None
    perm = np.random.default_rng(seed + 100).permutation(n)
    wj = jnorm.bucket_matrix(jnp.asarray(perm), n, s)
    wt = norm_agg.bucket_matrix(torch.as_tensor(perm), n, s)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    return wj, wt


def _both(x, wj, wt, mask, mean, std, attack, rule, trim=1):
    kw = {}
    if attack is not None:
        kw = dict(mask=mask, good_mean=mean, good_std=std)
    ref = jax_robust_agg(
        jnp.asarray(x) if isinstance(x, np.ndarray) else x, wj,
        *(jnp.asarray(kw[k]) if k in kw else None
          for k in ("mask", "good_mean", "good_std")),
        rule=rule, trim=trim, interpret=True,
        attack_fn=None if attack is None else JCoordAttack(
            attack, ATTACK_PARAM[attack]))
    return np.asarray(ref), kw


def _port(x, wt, kw, attack, rule, trim=1):
    t = (lambda a: None if a is None else torch.as_tensor(a))
    return robust_agg_plain(
        x, wt, t(kw.get("mask")), t(kw.get("good_mean")),
        t(kw.get("good_std")), rule=rule, trim=trim,
        attack=None if attack is None else CoordAttack(
            attack, ATTACK_PARAM[attack])).numpy()


def _check(got, ref, bucketed):
    if bucketed:
        np.testing.assert_allclose(got, ref, rtol=W_RTOL, atol=W_RTOL)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("s", [0, 2, 3])
@pytest.mark.parametrize("rule", ["mean", "median", "trimmed"])
def test_rules_with_alie(rule, s):
    x, mean, std, mask = _inputs(5, 123)
    wj, wt = _w(5, s)
    ref, kw = _both(x, wj, wt, mask, mean, std, "ALIE", rule)
    got = _port(torch.as_tensor(x), wt, kw, "ALIE", rule)
    _check(got, ref, s > 0)


@pytest.mark.parametrize("attack", [None, "BF", "IPM"])
@pytest.mark.parametrize("d", [1, 2100])
@pytest.mark.parametrize("n", [1, 4, 16])
def test_median_shapes_and_attacks(n, d, attack):
    x, mean, std, mask = _inputs(n, d, seed=n + d)
    ref, kw = _both(x, None, None, mask, mean, std, attack, "median")
    got = _port(torch.as_tensor(x), None, kw, attack, "median")
    _check(got, ref, False)


def _sparse(n, d, k, base_rows, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([rng.permutation(d)[:k] for _ in range(n)]),
                  axis=1).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    base = (None if base_rows == 0 else
            rng.standard_normal((base_rows, d)).astype(np.float32))
    jsrc = jq.WireSrc(fmt="sparse", n=n, d=d,
                      arrays=(("vals", jnp.asarray(vals)),
                              ("idx", jnp.asarray(idx))),
                      base=None if base is None else jnp.asarray(base))
    tsrc = quantize.WireSrc(fmt="sparse", n=n, d=d,
                            arrays=(("vals", torch.as_tensor(vals)),
                                    ("idx", torch.as_tensor(idx))),
                            base=None if base is None
                            else torch.as_tensor(base))
    return jsrc, tsrc


@pytest.mark.parametrize("base_rows", [0, 1, 5])
@pytest.mark.parametrize("s", [0, 2])
def test_sparse_wire(base_rows, s):
    n, d = 5, 2100
    jsrc, tsrc = _sparse(n, d, 210, base_rows)
    _, mean, std, mask = _inputs(n, d)
    wj, wt = _w(n, s)
    ref, kw = _both(jsrc, wj, wt, mask, mean, std, "ALIE", "median")
    got = _port(tsrc, wt, kw, "ALIE", "median")
    _check(got, ref, s > 0)


def test_wire_starts_bound_each_tile():
    _, tsrc = _sparse(4, 1000, 100, 0, seed=3)
    idx = dict(tsrc.arrays)["idx"]
    starts = quantize.wire_starts(idx, 1000, 128)
    assert starts.shape == (4, 9) and starts.dtype == torch.int32
    for i in range(4):
        for t in range(8):
            seg = idx[i, starts[i, t]:starts[i, t + 1]]
            assert ((seg >= 128 * t) & (seg < 128 * (t + 1))).all()
        assert starts[i, -1] == 100


@pytest.mark.parametrize("rule", ["mean", "cm", "tm"])
def test_aggregator_tree_with_bucketing(rule):
    rng = np.random.default_rng(4)
    xs = {"b": rng.standard_normal((5,)).astype(np.float32),
          "w": rng.standard_normal((5, 7, 3)).astype(np.float32)}
    ref = jagg.get_aggregator(rule, bucket_size=2).tree(
        jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in xs.items()})
    got = tagg.get_aggregator(rule, bucket_size=2).tree(
        R.PRNGKey(1), {k: torch.as_tensor(v) for k, v in xs.items()})
    for k in xs:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_cpu_tensors_take_the_plain_version():
    x, mean, std, mask = _inputs(5, 300)
    before = robust_agg.launches
    t = torch.as_tensor
    got = robust_agg(t(x), None, t(mask), t(mean), t(std), rule="median",
                     attack=CoordAttack("ALIE", 1.06))
    want = robust_agg_plain(t(x), None, t(mask), t(mean), t(std),
                            rule="median", attack=CoordAttack("ALIE", 1.06))
    assert robust_agg.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
