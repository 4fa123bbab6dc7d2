"""The paths of the int8, sign and bf16 wires and of bfloat16 stacks
against the reference, on the same numpy inputs and keys.

* ``kernels.ops`` on a bfloat16 (n, d) stack (``robust_agg``, ``rfa_agg``,
  ``krum_agg``) and ``wire_agg`` on every wire format with a bfloat16
  candidate dtype, against ``repro.kernels.ops`` (its kernels in
  interpret mode);
* the kernel wrappers' plain versions with ALIE on one row, where the
  forged row rounds through bfloat16 before the select, and on each new
  wire with its base, masked and unmasked, against the reference's
  ``robust_agg``, ``pair_gram``, ``rfa_iter`` and ``weighted_sum`` with
  ``attack_fn``;
* whole 20-round runs of the paths ``chip_smoke.py`` drives on the card
  (MARINA + int8 with cm, RFA and Krum; Byz-EF21 + sign and + bf16 with
  cm; the chaos plan on MARINA + int8 with cm and on Byz-EF21 + bf16 with
  Krum), at a9a's and gisette's widths cut to 300 samples.

Tolerances: bit for bit for the coordinate rules without a bucket
operator and for the weighted row sums; 1e-6 through W (W @ x sums in
another order); 1e-5 of the largest entry for sums over d (a Gram entry,
a squared distance, in XLA's dot order); 2e-5 for RFA, Krum and whole
runs, the reference's pallas≡gspmd tolerance. Runs keep the reference's
c_k coins and its communication count exactly. Under the chaos plan,
MARINA + int8 with cm diverges in both packages alike: the guard admits a
finite garbled norm by design, ALIE's statistics take it in, and with the
byzantine worker two of the three buckets are bad; the losses are
compared NaN for NaN. Byz-EF21 + sign compares losses, not parameters: a
coordinate of C's input within an ulp of zero (the gradients of the two
packages agree to ulps, not bits) takes the other sign and moves by
2·scale, so a few coordinates of the parameters part by ~1e-4 while the
loss stays within 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import run as jax_run
from repro.core import compressors as jcomp
from repro.core import wire as jwire
from repro.core.attacks import CoordAttack as JCoordAttack
from repro.kernels import norm_agg as jnorm
from repro.kernels import ops as jops
from repro.kernels import robust_agg as jrobust
from repro_torch.api import RunSpec, run
from repro_torch.convert import key_from_numpy
from repro_torch.core import compressors as tcomp
from repro_torch.core import wire as twire
from repro_torch.core.attacks import CoordAttack
from repro_torch.kernels import norm_agg, ops
from repro_torch.kernels.robust_agg import robust_agg

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

W_TOL = 1e-6
SUM_REL = 1e-5
NORM_TOL = 2e-5
TRAJ_TOL = 2e-5
N, D = 8, 700
ALIE = 1.06


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    if tol == 0:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


def _bf16_stack(n=N, d=D, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    return xj, _t(xj)


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("rule", ["median", "mean", "trimmed"])
def test_ops_robust_agg_on_a_bf16_stack(rule, s):
    xj, xt = _bf16_stack(seed=s)
    key = jax.random.PRNGKey(3)
    want = jops.robust_agg(xj, key, bucket_size=s, rule=rule)
    got = ops.robust_agg(xt, key_from_numpy(key), bucket_size=s, rule=rule)
    _close(got, want, W_TOL if s > 1 else 0)


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("name", ["rfa_agg", "krum_agg"])
def test_ops_norm_rules_on_a_bf16_stack(name, s):
    xj, xt = _bf16_stack(seed=10 + s)
    key = jax.random.PRNGKey(4)
    want = getattr(jops, name)(xj, key, bucket_size=s)
    got = getattr(ops, name)(xt, key_from_numpy(key), bucket_size=s)
    _close(got, want, NORM_TOL)


def _wire(fmt, base_rows, cand, seed=0):
    """(reference WireSrc, port WireSrc) of one leaf packed by both, the
    reference compiled; a base of 0, 1 or N rows, the candidate dtype
    ``cand``."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, D)) * rng.random((N, D))).astype(np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 i))(jnp.arange(N))
    base = (None if not base_rows else
            rng.standard_normal((base_rows, D)).astype(np.float32))
    jw = jwire.pack_candidates(jcomp.get_compressor(fmt), keys,
                               {"x": jnp.asarray(x)})
    jpay = jax.jit(lambda k, v: jwire.pack_candidates(
        jcomp.get_compressor(fmt), k, {"x": v}).payloads)(keys, x)
    jw = dataclasses.replace(jw, payloads=jpay)
    tw = twire.pack_candidates(tcomp.get_compressor(fmt), key_from_numpy(keys),
                               {"x": torch.as_tensor(x)})
    jsrc = dataclasses.replace(
        jwire.wire_srcs(jw)[0], cand_dtype=getattr(jnp, cand),
        base=None if base is None else jnp.asarray(base))
    tsrc = dataclasses.replace(
        twire.wire_srcs(tw)[0], cand_dtype=getattr(torch, cand),
        base=None if base is None else torch.as_tensor(base))
    return jsrc, tsrc


@pytest.mark.parametrize("rule", ["median", "mean", "trimmed", "rfa", "krum"])
@pytest.mark.parametrize("fmt", ["sparse", "int8", "sign", "bf16"])
def test_wire_agg_with_bf16_candidates(fmt, rule):
    if fmt == "sparse":
        jsrc, tsrc = _wire("int8", 1, "bfloat16")
        jsrc, tsrc = _sparse_twins(jsrc, tsrc)
    else:
        jsrc, tsrc = _wire(fmt, 1 if fmt == "int8" else N, "bfloat16")
    want = jops.wire_agg(jsrc, None, rule=rule)
    got = ops.wire_agg(tsrc, None, rule=rule)
    _close(got, want, NORM_TOL if rule in ("rfa", "krum") else 0)


def _sparse_twins(jsrc, tsrc):
    """A RandK payload with the base and candidate dtype of the given
    sources."""
    rng = np.random.default_rng(9)
    k = D // 10
    idx = np.sort(np.stack([rng.permutation(D)[:k] for _ in range(N)]),
                  axis=1).astype(np.int32)
    vals = rng.standard_normal((N, k)).astype(np.float32)
    return (dataclasses.replace(jsrc, fmt="sparse", arrays=(
                ("vals", jnp.asarray(vals)), ("idx", jnp.asarray(idx)))),
            dataclasses.replace(tsrc, fmt="sparse", arrays=(
                ("vals", torch.as_tensor(vals)),
                ("idx", torch.as_tensor(idx)))))


def _attack_inputs(n=N, d=D, seed=1, masked=False):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(d).astype(np.float32)
    std = np.abs(rng.standard_normal(d)).astype(np.float32)
    mask = np.arange(n) == 0                       # ALIE on one row
    valid = None if not masked else np.arange(n) != n - 1
    jkw = dict(mask=jnp.asarray(mask), good_mean=jnp.asarray(mean),
               good_std=jnp.asarray(std),
               valid=None if valid is None else jnp.asarray(valid))
    tkw = dict(mask=torch.as_tensor(mask), good_mean=torch.as_tensor(mean),
               good_std=torch.as_tensor(std),
               valid=None if valid is None else torch.as_tensor(valid))
    return jkw, tkw


def _check_kernels(jx, tx, masked, w_seed=2):
    """The four kernel wrappers' plain versions against the reference's
    kernels, ALIE fused, masked (worker N-1 invalid) or not."""
    jkw, tkw = _attack_inputs(masked=masked)
    jatt, tatt = JCoordAttack("ALIE", ALIE), CoordAttack("ALIE", ALIE)
    bv = {} if not masked else {"bvalid": jkw["valid"]}
    tbv = {} if not masked else {"bvalid": tkw["valid"]}
    want = jrobust.robust_agg(jx, None, rule="median", attack_fn=jatt,
                              **jkw, **bv)
    got = robust_agg(tx, rule="median", attack=tatt, **tkw, **tbv)
    _close(got, want, 0)
    wr = np.random.default_rng(w_seed).random(N).astype(np.float32) + 0.1
    wr /= wr.sum()
    want = jnorm.weighted_sum(jx, jnp.asarray(wr), attack_fn=jatt, **jkw)
    got = norm_agg.weighted_sum(tx, torch.as_tensor(wr), attack=tatt, **tkw)
    _close(got, want, 0)
    jz, jsq = jnorm.rfa_iter(jx, jnp.asarray(wr), attack_fn=jatt, **jkw)
    tz, tsq = norm_agg.rfa_iter(tx, torch.as_tensor(wr), attack=tatt, **tkw)
    _close(tz, jz, 0)
    np.testing.assert_allclose(tsq.numpy(), np.asarray(jsq), rtol=0,
                               atol=SUM_REL * float(np.max(jsq)))
    jg = np.asarray(jnorm.pair_gram(jx, attack_fn=jatt, **jkw))
    tg = norm_agg.pair_gram(tx, attack=tatt, **tkw).numpy()
    np.testing.assert_allclose(tg, jg, rtol=0,
                               atol=SUM_REL * float(np.abs(jg).max()))


@pytest.mark.parametrize("masked", [False, True])
def test_kernels_round_the_forged_row_of_a_bf16_stack(masked):
    """ALIE's value is not a bfloat16: on a bf16 stack the forged row
    rounds through bfloat16 before the select in both packages."""
    xj, xt = _bf16_stack(seed=5)
    _, tkw = _attack_inputs()
    forged = CoordAttack("ALIE", ALIE)(torch.zeros(1, D),
                                       tkw["good_mean"][None],
                                       tkw["good_std"][None])
    assert not torch.equal(forged.bfloat16().float(), forged)
    _check_kernels(xj, xt, masked)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cand", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["int8", "sign", "bf16"])
def test_kernels_on_the_new_wires(fmt, cand, masked):
    """MARINA's shared base for int8, Byz-EF21's per-worker base for sign
    and bf16."""
    jsrc, tsrc = _wire(fmt, 1 if fmt == "int8" else N, cand, seed=7)
    _check_kernels(jsrc, tsrc, masked)


CHAOS = dict(fault_guard=True, faults={"seed": 0, "faults": [
    {"kind": "nan_grad", "prob": 0.2, "workers": [4]},
    {"kind": "corrupt_wire", "prob": 0.2, "workers": [4]}]})
A9A = dict(task="logreg", method="marina", n_workers=5, n_byz=1,
           attack="ALIE", aggregator="cm", bucket_size=2, agg_mode="pallas",
           compressor="int8", p=0.1, lr=0.5, steps=20,
           data_kwargs={"n_samples": 300, "dim": 123, "batch_size": 32})
GISETTE = dict(A9A, method="byz_ef21", compressor="sign",
               data_kwargs={"n_samples": 300, "dim": 5000,
                            "batch_size": 32})
PATHS = {
    "marina int8 cm": A9A,
    "marina int8 rfa": dict(A9A, aggregator="rfa"),
    "marina int8 krum": dict(A9A, aggregator="krum"),
    "marina int8 cm gspmd": dict(A9A, agg_mode="gspmd"),
    "byz_ef21 sign cm": GISETTE,
    "byz_ef21 bf16 cm": dict(GISETTE, compressor="bf16"),
    "marina int8 chaos cm": dict(A9A, **CHAOS),
    "byz_ef21 bf16 chaos krum": dict(GISETTE, compressor="bf16",
                                     aggregator="krum", **CHAOS),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_run_matches_reference(path):
    spec = PATHS[path]
    ref = jax_run(JaxRunSpec(**spec), log_every=1)
    got = run(RunSpec(**spec), device="cpu", log_every=1)
    assert ([int(h.get("c_k", 1)) for h in got.history]
            == [int(h.get("c_k", 1)) for h in ref.history])
    if spec["method"] == "marina":
        assert {int(h["c_k"]) for h in got.history} == {0, 1}
    assert got.comm_bits == ref.comm_bits
    assert ([h["wire_bits"] for h in got.history]
            == [h["wire_bits"] for h in ref.history])
    losses = [h["loss"] for h in got.history]
    np.testing.assert_allclose(losses, [h["loss"] for h in ref.history],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    if "int8 chaos" in path:
        return
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    if "sign" not in path:
        for k, v in got.params.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref.params[k]),
                                       rtol=TRAJ_TOL, atol=TRAJ_TOL)
