"""The port's checkpoints against the reference's: a round trip bit for
bit, and the file format shared, so a checkpoint written by either
package loads in the other and the manifests are equal JSON."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import build as jax_build
from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro_torch import random as R
from repro_torch.api import RunSpec, build
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.convert import state_from_numpy

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

SPEC = dict(n_workers=5, n_byz=1, attack="ALIE", aggregator="cm",
            bucket_size=2, compressor="randk",
            compressor_kwargs={"ratio": 0.5}, p=0.3, lr=0.25, steps=4, seed=3,
            data_kwargs={"dim": 30, "n_samples": 60, "batch_size": 8})
# estimator state of every kind: per-worker trees (diana's worker_h,
# byz_ef21's worker_g, saga's (n, m, d) table), a parameter tree (svrg's
# snapshot) and a 0-d float (diana's alpha)
METHODS = {"diana": {}, "saga": {"method_kwargs": {"batch_size": 8}},
           "svrg": {"aggregator": "rfa"},
           "byz_ef21": {"compressor": "topk"}}


def _spec_kw(method):
    return {**SPEC, "method": method, **METHODS[method]}


@functools.cache
def _states(method):
    """The reference's and the port's ``method.init`` state of one spec
    (made once a method; no test changes them)."""
    jexp = jax_build(JaxRunSpec(**_spec_kw(method)))
    k_init, k_run = jax.random.split(jax.random.PRNGKey(3))
    ref = jax.jit(jexp.method.init)(jexp.init_params(k_init), jexp.anchor(0),
                                    k_run)
    exp = build(RunSpec(**_spec_kw(method)), device="cpu")
    k_init, k_run = R.split(R.PRNGKey(3))
    got = exp.method.init(exp.init_params(k_init), exp.anchor(0), k_run)
    return jax.device_get(ref), got


def _equal(a, b):
    assert type(a) is type(b) or isinstance(a, torch.Tensor)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert a.shape == b.shape
        # bit for bit: -0.0 and NaN payloads included
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    else:
        assert a == b


def test_round_trip_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn(3, 4, generator=g),
                        "b": torch.randn(4, generator=g).bfloat16()},
             "alpha": torch.tensor(0.25),
             "count": torch.tensor(7, dtype=torch.int32),
             "idx": torch.arange(5, dtype=torch.int64),
             "nested": [torch.randn(2, generator=g),
                        {"z": torch.zeros((), dtype=torch.bfloat16)}],
             "opt_state": None, "step": 42}
    save_checkpoint(str(tmp_path / "ck"), state, step=42)
    back, step = load_checkpoint(str(tmp_path / "ck"), state)
    assert step == 42
    _equal(back, state)
    assert back["params"]["w"].data_ptr() != state["params"]["w"].data_ptr()
    manifest = json.loads((tmp_path / "ck.json").read_text())
    assert manifest["leaves"]["params/b"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["step"] == {"name": "leaf_00007",
                                          "dtype": "int32", "shape": []}
    assert "opt_state" not in manifest["leaves"]


def test_a_wrong_shape_is_refused(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path / "ck"), {"w": torch.zeros(4)})


@pytest.mark.parametrize("method", sorted(METHODS))
def test_reference_checkpoint_loads_in_the_port(method, tmp_path):
    ref, like = _states(method)
    jax_save(str(tmp_path / "ref"), ref, step=0)
    got, step = load_checkpoint(str(tmp_path / "ref"), like)
    assert step == 0
    _equal(got, state_from_numpy(ref))


@pytest.mark.parametrize("method", sorted(METHODS))
def test_port_checkpoint_loads_in_the_reference(method, tmp_path):
    ref, got = _states(method)
    save_checkpoint(str(tmp_path / "port"), got, step=got["step"])
    back, step = jax_load(str(tmp_path / "port"), ref)
    assert step == 0

    def leaves(tree):
        return {tuple(p.key for p in path): np.asarray(leaf) for path, leaf
                in jax.tree_util.tree_flatten_with_path(tree)[0]}

    want = leaves(ref)
    loaded = leaves(back)
    assert sorted(loaded) == sorted(want)
    for path, leaf in loaded.items():
        node = got
        for k in path:
            node = node[k]
        assert leaf.dtype == want[path].dtype, path
        np.testing.assert_array_equal(
            leaf, node if isinstance(node, int) else node.numpy())
    # the manifests of the two packages' checkpoints are equal JSON
    jax_save(str(tmp_path / "ref"), ref, step=0)
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "ref.json").read_text()))


def test_bfloat16_crosses_both_ways(tmp_path):
    vals = np.array([1.5, -0.0, 3.140625, np.inf], np.float32)
    jtree = {"b": jnp.asarray(vals, jnp.bfloat16), "w": jnp.asarray(vals)}
    ttree = {"b": torch.tensor(vals).bfloat16(), "w": torch.tensor(vals)}
    jax_save(str(tmp_path / "ref"), jtree, step=1)
    got, _ = load_checkpoint(str(tmp_path / "ref"), ttree)
    _equal(got, ttree)
    save_checkpoint(str(tmp_path / "port"), ttree, step=1)
    back, _ = jax_load(str(tmp_path / "port"), jtree)
    for k in jtree:
        assert back[k].dtype == jtree[k].dtype
        np.testing.assert_array_equal(np.asarray(back[k], np.float32),
                                      vals)
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "ref.json").read_text()))
