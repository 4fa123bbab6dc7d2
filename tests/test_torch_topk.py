"""The port's TopK against the reference: ``topk_select`` and
``topk_support`` (an exact radix select of each row's threshold, an
ordered compaction of the support), the TopK sparse wire and the dense
compressor.

``topk_select_plain``, the entry points ``topk_select`` and
``topk_support`` on CPU tensors, and the radix select's plain twins
(``topk_threshold_plain``, ``topk_compact_plain``) are held to
``repro.kernels.quantize.topk_select`` run in interpret mode (its Pallas
pool kernel takes every input wider than 4096), on the same numpy
inputs: the same indices in the same order (or, for the support, the
same set in ascending order), with no tolerance, also on inputs full of
exact |x| ties (small integers with random signs), where the order is
descending |x| and ties go to the lower index. NaN, ±0 and runs of equal
keys across the digits' boundaries are held to a full stable sort. The
CUDA select kernels are held to the twins on the card by
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

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

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


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("ratio", [0.1, None])
@pytest.mark.parametrize("d", [4097, (1 << 16) + 3])
def test_topk_support_matches_reference(d, ratio, ties):
    """The support (ascending indices, and x at them) is the reference's
    selection sorted; the plain twin and the entry point agree."""
    x = _x((2, d), ties, d + 1)
    k = _k(d, ratio)
    before = quantize.topk_select.calls
    idx, vals = quantize.topk_support(torch.as_tensor(x), k)
    assert quantize.topk_select.calls == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (2, k)
    np.testing.assert_array_equal(
        idx.numpy(), quantize.topk_support_plain(torch.as_tensor(x), k)[0])
    for row in range(2):
        ref = np.sort(np.asarray(jq.topk_select(jnp.asarray(x[row]), k,
                                                interpret=True)))
        np.testing.assert_array_equal(idx[row].numpy(), ref)
        np.testing.assert_array_equal(vals[row].numpy(), x[row, ref])


def _stable_order(x):
    """Columns of each row by descending |x|, NaN first, ties to the lower
    index (a stable lexicographic sort: NaN or not, then -|x|)."""
    a = np.abs(x.astype(np.float32))
    nan = np.isnan(a)
    return np.stack([np.lexsort((-np.where(n, 0, r), ~n))
                     for r, n in zip(a, nan)])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("d", [4097, 5000])
def test_topk_threshold_plain_is_the_kth_key(d, ties):
    """T is the k-th largest key, G the keys above it, need = k − G, and
    1 <= need <= the keys equal to T, at every k tried."""
    x = _x((3, d), ties, d + 2)
    t = torch.as_tensor(x)
    keys = quantize.topk_keys(t).numpy().astype(np.int64)
    order = _stable_order(x)
    for k in (1, 2, d // 10, d // 2, d - 1, d):
        T, G, need = (v.numpy() for v in quantize.topk_threshold_plain(t, k))
        for row in range(3):
            kth = keys[row, order[row, k - 1]]
            assert T[row] == kth
            assert G[row] == (keys[row] > kth).sum()
            assert need[row] == k - G[row]
            assert 1 <= need[row] <= (keys[row] == kth).sum()


def _odd_rows(d, seed):
    """Rows of NaN (both signs) and +inf, of ±0 with a few ones, and of
    keys spread over ±1100 ulps of 1.5 (runs of equal keys that cross the
    10-bit digits' boundaries), with random signs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, d)).astype(np.float32)
    x[0, rng.integers(0, d, 60)] = np.nan
    x[0, 7] = np.inf
    x[0, 11] = -np.nan
    x[1] = np.where(rng.random(d) < 0.5, 0.0, -0.0)
    x[1, :40] = 1.0
    bits = np.uint32(0x3FC00000) + rng.integers(-1100, 1100, d)
    x[2] = bits.astype(np.uint32).view(np.float32) * np.where(
        rng.random(d) < 0.5, -1, 1)
    return x


K_OF = {"one": lambda d: 1, "45": lambda d: 45, "tenth": lambda d: d // 10,
        "all_but_one": lambda d: d - 1}


@pytest.mark.parametrize("k_of", sorted(K_OF))
@pytest.mark.parametrize("d", [4097, 20001])
def test_topk_select_orders_nan_zeros_and_runs(d, k_of):
    """NaN above +inf and NaNs tied to the lower index, +0 and -0 tied, and
    runs of equal keys across digit boundaries: ``topk_select`` (and
    ``topk_select_plain``) equal a full stable sort, ``topk_support`` its
    first k sorted."""
    x = _odd_rows(d, d)
    k = K_OF[k_of](d)
    want = _stable_order(x)[:, :k]
    t = torch.as_tensor(x)
    np.testing.assert_array_equal(quantize.topk_select(t, k).numpy(), want)
    np.testing.assert_array_equal(quantize.topk_select_plain(t, k).numpy(),
                                  want)
    np.testing.assert_array_equal(quantize.topk_support(t, k)[0].numpy(),
                                  np.sort(want, axis=-1))


def test_topk_compact_plain_keeps_the_first_ties_in_index_order():
    """With T tied many times, the compaction keeps every key above T and
    the first ``need`` keys equal to T, in ascending index order."""
    d = 2 * quantize.TOPK_TILE + 5
    x = np.zeros((1, d), np.float32)
    x[0, ::3] = 2.0                      # 1367 keys equal to T = 2.0
    x[0, 100] = 5.0
    k = 11
    idx, vals = quantize.topk_compact_plain(torch.as_tensor(x), k)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx[0].numpy(),
                                  [0, 3, 6, 9, 12, 15, 18, 21, 24, 27, 100])
    np.testing.assert_array_equal(vals[0].numpy(), [2.0] * 10 + [5.0])
    T, G, need = quantize.topk_threshold_plain(torch.as_tensor(x), k)
    assert int(G[0]) == 1 and int(need[0]) == 10
    assert int(T[0]) == int(np.float32(2.0).view(np.int32))


@pytest.mark.parametrize("k", [0, 4098])
def test_topk_select_refuses_k_outside_the_row(k):
    x = torch.as_tensor(_x((2, 4097), False, 3))
    for fn in (quantize.topk_select, quantize.topk_support,
               quantize.topk_select_plain):
        with pytest.raises(ValueError, match="outside"):
            fn(x, k)


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
