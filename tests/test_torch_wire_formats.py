"""The int8, sign and bf16 wires of the port against the reference.

The same numpy inputs and keys go through both packages. The reference
runs under ``jax.jit``, as ``api.run`` compiles it: there its division by
127 is a product with the rounded reciprocal, its dither ``scaled·127 +
u`` one fused multiply-add, and, on a float32 int8 payload with a base,
the decode's last product and the base add one fused multiply-add. Bit
for bit: the compressors, the packed payloads, ``decoded_payload`` (also
against ``compress_tree``), ``reconstruct``, ``quantize.recon`` against
the reference's ``recon_block`` on each tile, the bit flips of the fault
layer and the decode guard on flipped payloads. The wire bits agree
exactly with ``tree_wire_bits`` and ``theory.comm_bits_per_round``.
``wire_stats`` is held to 1 ulp (a square root).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import theory as jtheory
from repro.core import wire as jwire
from repro.faults import guard as jguard
from repro.faults import inject as jinject
from repro.faults.plan import as_plan as jas_plan
from repro.kernels import quantize as jq
from repro_torch.convert import key_from_numpy
from repro_torch.core import compressors as tcomp
from repro_torch.core import theory as ttheory
from repro_torch.core import tree_utils as ttu
from repro_torch.core import wire as twire
from repro_torch.faults import guard as tguard
from repro_torch.faults import inject as tinject
from repro_torch.faults.plan import as_plan as tas_plan
from repro_torch.kernels import quantize as tq

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

N = 5
FORMATS = ("int8", "sign", "bf16")
DIMS = (1, 123, 5000)          # leaf b, a9a's width, gisette's width


def _t(a):
    """A numpy or JAX array -> tensor, bfloat16 kept."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bytes(x):
    """The raw bytes of a tensor or array, to compare payloads bit for
    bit whatever their dtype."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().reshape(-1).numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(x).reshape(-1)).view(np.uint8)


def _same(got, want):
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


def _same_but_nan_payloads(got, want):
    """Bit for bit, except that a NaN matches any NaN of the same sign:
    XLA's select on bfloat16 on the CPU goes through float32 and quiets a
    NaN's payload."""
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(np.signbit(g), np.signbit(w))
    keep = np.repeat(~np.isnan(w).reshape(-1), got.element_size())
    np.testing.assert_array_equal(_bytes(got)[keep], _bytes(want)[keep])


def _keys(seed):
    return jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(seed), i))(jnp.arange(N))


def _case(fmt, dim, base, seed=0):
    """(stacked, base tree, reference wire, port wire). ``base``: None,
    "shared" (MARINA's g, one row) or "worker" (Byz-EF21's g_i, n rows)."""
    rng = np.random.default_rng(seed + dim)
    stacked = {"b": rng.standard_normal((N,)).astype(np.float32),
               "w": (rng.standard_normal((N, dim))
                     * rng.random((N, dim))).astype(np.float32)}
    lead = () if base == "shared" else (N,)
    g = (None if base is None else
         {"b": rng.standard_normal(lead).astype(np.float32),
          "w": rng.standard_normal(lead + (dim,)).astype(np.float32)})
    jkeys = _keys(seed)
    comp = jcomp.get_compressor(fmt)

    def pack(keys, x, b):
        return jwire.pack_candidates(comp, keys, x, base=b,
                                     base_shared=base == "shared")

    jw0 = pack(jkeys, stacked, g)
    payloads, bases = jax.jit(lambda k, x, b: (pack(k, x, b).payloads,
                                               pack(k, x, b).base))(
        jkeys, stacked, g)
    jw = dataclasses.replace(jw0, payloads=payloads, base=bases)
    tw = twire.pack_candidates(
        tcomp.get_compressor(fmt), key_from_numpy(jkeys),
        {k: _t(v) for k, v in stacked.items()},
        base=None if g is None else {k: _t(v) for k, v in g.items()},
        base_shared=base == "shared")
    return stacked, g, jw, tw


def _jit_view(fn, jw):
    """A wire view of the reference, compiled as in a run."""
    return jax.jit(lambda p, b: fn(dataclasses.replace(jw, payloads=p,
                                                       base=b)))(
        jw.payloads, jw.base)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dim", DIMS)
def test_compress_bit_exact(fmt, dim):
    rng = np.random.default_rng(dim)
    x = (rng.standard_normal(dim) * rng.random(dim)).astype(np.float32)
    key = jax.random.PRNGKey(dim + 7)
    want = jax.jit(jcomp.get_compressor(fmt).compress)(key, x)
    got = tcomp.get_compressor(fmt).compress(key_from_numpy(key), _t(x))
    _same(got, want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_compressor_attributes_match_reference(fmt):
    j, t = jcomp.get_compressor(fmt), tcomp.get_compressor(fmt)
    assert (t.name, t.wire_format, t.fallback_only, t.common_randomness) == (
        j.name, j.wire_format, j.fallback_only, j.common_randomness)
    assert (t.contractive_fn is None) == (j.contractive_fn is None)
    for d in (1, 123, 255, 256, 257, 5000, 1 << 22):
        np.testing.assert_equal(
            [t.omega_fn(d), t.bits_fn(d), t.density_fn(d)],
            [j.omega_fn(d), j.bits_fn(d), j.density_fn(d)])
        if j.contractive_fn is not None:
            assert t.contractive_fn(d) == j.contractive_fn(d)
    assert (fmt in tcomp.CONTRACTIVE) == (j.contractive_fn is not None)


@pytest.mark.parametrize("d", [123, 5000, 1 << 22])
def test_sign_scale_takes_xla_lane_order(d):
    """mean(|x|) of the reference's compiled code: the lane sum in XLA's
    windows of 32 times the rounded 1/d, at a9a's, gisette's and a
    qwen3-1.7b q_proj layer's width."""
    x = np.random.default_rng(d).standard_normal((2, d)).astype(np.float32)
    want = jax.jit(jax.vmap(jq.pack_sign))(jnp.zeros((2, 2), jnp.uint32), x)
    got = tq.pack_sign(None, _t(x))
    _same(got["scale"], want["scale"])
    _same(got["signs"], want["signs"])


@pytest.mark.parametrize("base", [None, "shared", "worker"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dim", [123, 5000])
def test_pack_decode_reconstruct_bit_exact(fmt, dim, base):
    _, _, jw, tw = _case(fmt, dim, base)
    assert tw.fmt == jw.fmt == fmt and tw.names == ("b", "w")
    assert tw.shapes == tuple(tuple(s) for s in jw.shapes)
    for jp, tp in zip(jw.payloads, tw.payloads):
        assert sorted(jp) == sorted(tp)
        for name in jp:
            assert tuple(tp[name].shape) == jp[name].shape
            _same(tp[name], jp[name])
    for name in ("decoded_payload", "reconstruct"):
        want = _jit_view(getattr(jwire, name), jw)
        got = getattr(twire, name)(tw)
        for k in want:
            _same(got[k], want[k])


@pytest.mark.parametrize("fmt", FORMATS)
def test_decoded_payload_equals_compress_tree(fmt):
    stacked, _, _, tw = _case(fmt, 123, "shared", seed=2)
    qkeys = key_from_numpy(_keys(2))
    dec = twire.decoded_payload(tw)
    comp = tcomp.get_compressor(fmt)
    for i in range(N):
        want = ttu.compress_tree(comp, qkeys[i],
                                 {k: _t(v[i]) for k, v in stacked.items()})
        for k in want:
            _same(dec[k][i], want[k])


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dim", DIMS)
def test_wire_bits_agree_everywhere(fmt, dim):
    """measured_bits ≡ tree_wire_bits ≡ comm_bits_per_round(dims=...)
    (Byz-EF21's family: one upload every round) ≡ the reference's."""
    stacked, _, jw, tw = _case(fmt, dim, None)
    dims = [1, dim]
    measured = twire.measured_bits(tw)
    assert measured == jwire.measured_bits(jw)
    assert measured == twire.tree_wire_bits(
        tcomp.get_compressor(fmt), {k: _t(v) for k, v in stacked.items()})
    assert measured == jwire.tree_wire_bits(jcomp.get_compressor(fmt),
                                            stacked)
    for method, p, part in (("byz_ef21", 1.0, 1.0), ("marina", 0.1, 1.0),
                            ("marina", 0.1, 0.8), ("sgd", 1.0, 0.5)):
        got = ttheory.comm_bits_per_round(
            method, tcomp.get_compressor(fmt), 0, p=p, dims=dims,
            participation=part)
        assert got == jtheory.comm_bits_per_round(
            method, jcomp.get_compressor(fmt), 0, p=p, dims=dims,
            participation=part)
        if method == "byz_ef21":
            assert got == measured
    assert (ttheory.comm_bits_per_round("marina", tcomp.get_compressor(fmt),
                                        dim, p=0.1)
            == jtheory.comm_bits_per_round(
                "marina", jcomp.get_compressor(fmt), dim, p=0.1))


@pytest.mark.parametrize("sanitize", [False, True])
@pytest.mark.parametrize("base", [None, "shared", "worker"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_stats_within_one_ulp(fmt, base, sanitize):
    _, _, jw, tw = _case(fmt, 5000, base, seed=3)
    good = np.arange(N) != 1
    jm, js = jax.jit(lambda p, b, g: jwire.wire_stats(
        dataclasses.replace(jw, payloads=p, base=b), g,
        sanitize=sanitize))(jw.payloads, jw.base, jnp.asarray(good))
    tm, ts = twire.wire_stats(tw, torch.as_tensor(good), sanitize=sanitize)
    for got, want in zip(tm + ts, jm + js):
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                        maxulp=1)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "bf16", "float32",
                                   "int32"])
def test_flip_bits_bit_exact(dtype):
    rng = np.random.default_rng(4)
    if dtype in ("bf16", "float32"):
        a = jnp.asarray(rng.standard_normal((N, 300)).astype(np.float32))
        a = a.astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    else:
        info = np.iinfo(dtype)
        a = jnp.asarray(rng.integers(info.min, info.max, (N, 300),
                                     endpoint=True).astype(dtype))
    key = jax.random.PRNGKey(11)
    want = jax.jit(jinject._flip_bits)(a, key)
    got = tinject._flip_bits(_t(a), key_from_numpy(key))
    assert got.dtype == _t(a).dtype
    _same(got, want)


PLAN = {"seed": 3, "faults": [
    {"kind": "corrupt_wire", "prob": 1.0, "workers": [1, 3]},
    {"kind": "nan_grad", "prob": 1.0, "workers": [4]}]}


@pytest.mark.parametrize("fmt", FORMATS)
def test_injected_payloads_and_guard_match_reference(fmt):
    """corrupt_wire flips the 8-bit levels and signs, the 16-bit values
    and the float32 norms and scales of workers 1 and 3; nan_grad fills
    worker 4's float arrays. The flipped payloads and the decode guard's
    verdict equal the reference's."""
    _, _, jw, tw = _case(fmt, 5000, "shared", seed=5)
    key = jax.random.PRNGKey(21)
    jpay = jax.jit(lambda p: jinject.inject_wire(
        jas_plan(PLAN), key, dataclasses.replace(jw, payloads=p)).payloads)(
        jw.payloads)
    tw2 = tinject.inject_wire(tas_plan(PLAN), key_from_numpy(key), tw)
    for jp, tp in zip(jpay, tw2.payloads):
        for name in jp:
            if tp[name].dtype == torch.bfloat16:
                _same_but_nan_payloads(tp[name], jp[name])
            else:
                _same(tp[name], jp[name])
    jvalid = np.asarray(jguard.payload_valid(
        dataclasses.replace(jw, payloads=jpay)))
    tvalid = tguard.payload_valid(tw2).numpy()
    np.testing.assert_array_equal(tvalid, jvalid)
    assert not tvalid[4]


def _tiles(fmt, d, tile):
    return [(a, min(a + tile, d)) for a in range(0, -(-d // tile) * tile,
                                                 tile)]


@pytest.mark.parametrize("cand", ["float32", "bfloat16"])
@pytest.mark.parametrize("base_rows", [0, 1, N])
@pytest.mark.parametrize("fmt", FORMATS)
def test_recon_equals_recon_block_per_tile(fmt, base_rows, cand):
    """``quantize.recon`` against the reference's kernel body
    ``recon_block``, compiled, on each (n, tile) tile of the payload
    (int8 tiles of whole 256-blocks, as ``wire_tile`` makes them)."""
    d, tile = 700, 256
    rng = np.random.default_rng(base_rows)
    x = (rng.standard_normal((N, d)) * 3).astype(np.float32)
    keys = _keys(base_rows)
    pay = jax.jit(jax.vmap(getattr(jq, f"pack_{fmt}")))(keys, x)
    base = (None if not base_rows else
            rng.standard_normal((base_rows, d)).astype(np.float32))
    jdt = jnp.bfloat16 if cand == "bfloat16" else jnp.float32
    meta = jq.WireMeta(fmt=fmt, n=N, d=d, tile=tile, base_rows=base_rows,
                       cand_dtype=jdt)
    dp = -(-d // tile) * tile

    def pad(a):
        return jnp.pad(a, ((0, 0), (0, dp - a.shape[1])))

    env_full = {}
    if fmt == "int8":
        env_full = {"w_lev": pad(pay["lev"]), "w_norms": pay["norms"]}
    elif fmt == "sign":
        env_full = {"w_signs": pad(pay["signs"]), "w_scale": pay["scale"]}
    else:
        env_full = {"w_bf": pad(pay["vals"])}
    if base_rows:
        env_full["w_base"] = pad(jnp.asarray(base))
    body = jax.jit(lambda env: jq.recon_block(env, meta))
    tiles = []
    for a, b in _tiles(fmt, dp, tile):
        env = {}
        for name, arr in env_full.items():
            if name == "w_norms":
                env[name] = arr[:, a // 256:b // 256]
            elif name == "w_scale":
                env[name] = arr
            else:
                env[name] = arr[:, a:b]
        tiles.append(body(env))
    want = np.concatenate([np.asarray(t) for t in tiles], axis=1)[:, :d]
    src = tq.WireSrc(fmt=fmt, n=N, d=d,
                     arrays=tuple((k, _t(v)) for k, v in pay.items()),
                     base=None if base is None else _t(base),
                     cand_dtype=getattr(torch, cand))
    _same(tq.recon(src), want)
