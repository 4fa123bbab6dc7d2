"""The port's TopK against the reference: ``topk_select`` (per-tile pools,
then an exact select), the TopK sparse wire and the dense compressor.

``topk_select_plain`` and the entry point ``topk_select`` on CPU tensors
are held to ``repro.kernels.quantize.topk_select`` run in interpret mode
(its Pallas pool kernel takes every input wider than 4096), on the same
numpy inputs: the same indices in the same order, with no tolerance,
also on inputs full of exact |x| ties (small integers with random signs),
where the order is descending |x| and ties go to the lower index. The
CUDA pool kernel is held to the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import wire as jwire
from repro.kernels import quantize as jq
from repro_torch.convert import key_from_numpy, tree_from_numpy
from repro_torch.core import compressors as tcomp
from repro_torch.core import tree_utils as ttu
from repro_torch.core import wire as twire
from repro_torch.kernels import quantize

STATS_TOL = 1e-6       # scatter-adds sum in another order
N = 5


def _x(shape, ties, seed):
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _k(d, ratio):
    return 1 if ratio is None else max(int(ratio * d), 1)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("ratio", [0.5, 0.1, 0.01, None])
@pytest.mark.parametrize("d", [4097, 5000, (1 << 16) + 3])
def test_topk_select_matches_reference(d, ratio, ties):
    x = _x((2, d), ties, d)
    k = _k(d, ratio)
    before = quantize.topk_select.calls
    got = quantize.topk_select(torch.as_tensor(x), k)
    plain = quantize.topk_select_plain(torch.as_tensor(x), k)
    assert quantize.topk_select.calls == before + 1
    assert got.dtype == torch.int32 and got.shape == (2, k)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    for row in range(2):
        ref = jq.topk_select(jnp.asarray(x[row]), k, interpret=True)
        np.testing.assert_array_equal(got[row].numpy(), np.asarray(ref))
    assert quantize.topk_select.launches == 0          # plain on the CPU


@pytest.mark.parametrize("d", [1, 123, 4096])
def test_topk_select_without_the_pool_kernel(d):
    """Up to two tiles wide the reference sorts |x| alone (``lax.top_k``),
    and so does the port."""
    x = _x((3, d), True, d)
    k = _k(d, 0.1)
    got = quantize.topk_select(torch.as_tensor(x), k)
    for row in range(3):
        ref = jq.topk_select(jnp.asarray(x[row]), k, interpret=True)
        np.testing.assert_array_equal(got[row].numpy(), np.asarray(ref))


@pytest.mark.parametrize("k, cp", [(1, 128), (128, 128), (129, 256),
                                   (500, 512), (2048, 2048), (419430, 2048)])
def test_topk_pool_width(k, cp):
    assert quantize.topk_pool_width(k) == cp


def test_topk_pool_plain_keeps_each_tiles_top_and_pads_below():
    d = 2 * quantize.TOPK_TILE + 5
    x = torch.as_tensor(_x((1, d), True, 1))
    pv, pi = quantize.topk_pool_plain(x, 128)
    assert pv.shape == pi.shape == (1, 3, 128)
    assert pi.dtype == torch.int32
    real = pi < d
    want = torch.where(real, x.abs()[0, torch.where(real, pi, 0).long()],
                       torch.tensor(-1.0))
    np.testing.assert_array_equal(pv.numpy(), want.numpy())
    last = pv[0, 2]
    assert (last[:5] >= 0).all() and (last[5:] == -1.0).all()
    assert (pi[0, 2, 5:] == torch.arange(d, d + 123)).all()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("d", [1, 123, 4500])
def test_pack_sparse_topk_matches_reference(d, ties):
    x = _x((N, d), ties, d + 7)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(0), i))(
        jnp.arange(N))
    ref = jax.vmap(lambda kk, r: jq.pack_sparse(kk, r, 0.1, topk=True))(
        keys, jnp.asarray(x))
    got = quantize.pack_sparse(key_from_numpy(keys), torch.as_tensor(x), 0.1,
                               topk=True)
    for name in ("vals", "idx"):
        assert got[name].dtype == (torch.int32 if name == "idx"
                                   else torch.float32)
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(), (7,), (40,), (3, 1700)])
def test_top_k_compressor_matches_reference(shape, ties):
    x = _x(shape, ties, 11)
    jc, tc = jcomp.top_k(0.1), tcomp.top_k(0.1)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jc.compress(key, jnp.asarray(x)))
    got = tc.compress(key_from_numpy(key), torch.as_tensor(x))
    assert got.shape == tuple(shape) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    d = max(int(np.prod(shape)), 1)
    assert tc.name == jc.name
    assert tc.bits_per_vector(d) == jc.bits_per_vector(d)
    assert tc.contractive_fn(d) == jc.contractive_delta(d)
    assert tc.wire_format == jc.wire_format == "sparse"


def test_contractive_names_match_reference():
    assert tcomp.CONTRACTIVE == tuple(sorted(
        name for name, make in jcomp.REGISTRY.items()
        if make().contractive_fn is not None))


def _wire_case(seed, dim):
    """A TopK payload with Byz-EF21's per-worker (n-row) base, packed by
    both packages from the same stacked differences and keys."""
    rng = np.random.default_rng(seed)
    diffs = {"b": rng.standard_normal((N,)).astype(np.float32),
             "w": rng.integers(-3, 4, (N, dim)).astype(np.float32)}
    base = {"b": rng.standard_normal((N,)).astype(np.float32),
            "w": rng.standard_normal((N, dim)).astype(np.float32)}
    jkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(seed), i))(jnp.arange(N))
    jw = jwire.pack_candidates(
        jcomp.top_k(0.1), jkeys, {k: jnp.asarray(v) for k, v in diffs.items()},
        base={k: jnp.asarray(v) for k, v in base.items()})
    tw = twire.pack_candidates(
        tcomp.top_k(0.1), key_from_numpy(jkeys), tree_from_numpy(diffs),
        base=tree_from_numpy(base))
    return diffs, jkeys, jw, tw


@pytest.mark.parametrize("dim", [40, 4500])
def test_topk_wire_matches_reference(dim):
    diffs, jkeys, jw, tw = _wire_case(dim, dim)
    assert [b.shape for b in tw.base] == [(N, 1), (N, dim)]
    for jp, tp in zip(jw.payloads, tw.payloads):
        for name in ("vals", "idx"):
            np.testing.assert_array_equal(tp[name].numpy(),
                                          np.asarray(jp[name]))
    for fn in ("decoded_payload", "reconstruct"):
        ref = getattr(jwire, fn)(jw)
        got = getattr(twire, fn)(tw)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    # the payload decodes to what the dense compressor keeps
    dec = twire.decoded_payload(tw)
    for i in range(N):
        want = ttu.compress_tree(tcomp.top_k(0.1), key_from_numpy(jkeys)[i],
                                 {k: torch.as_tensor(v[i])
                                  for k, v in diffs.items()})
        for k in want:
            torch.testing.assert_close(dec[k][i], want[k], rtol=0, atol=0)
    good = np.arange(N) >= 1
    jm, js = jwire.wire_stats(jw, jnp.asarray(good))
    tm, ts = twire.wire_stats(tw, torch.as_tensor(good))
    for a, b in zip(tm + ts, jm + js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=STATS_TOL,
                                   atol=STATS_TOL)
    assert twire.tree_wire_bits(tcomp.top_k(0.1), tree_from_numpy(diffs)) \
        == jwire.tree_wire_bits(jcomp.top_k(0.1),
                                {k: jnp.asarray(v) for k, v in diffs.items()})
