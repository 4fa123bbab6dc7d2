"""State-space and hybrid LM training through the port's runner,
checkpoints and training CLI, against the reference package on the CPU:
mamba2-130m and recurrentgemma-2b, both ``reduced()``.

Tolerances: a 4-round run of the paper's main path (Byz-VR-MARINA +
RandK 0.1 + ALIE + cm, s = 2; p = 0.5, so that full and compressed
rounds both come) on each config is held to ``repro.api.run`` on gspmd,
the reference jitted as its runner compiles it: c_k equal, losses within
TRAJ_TOL, and the parameters by the reference's own pallas ≡ gspmd check
(``tests/test_estimator_contract.py``: atol and rtol TRAJ_TOL). XLA's CPU
dots sum in another order than torch's, which parts single gradients by
about 1e-6 of their scale; a VR round's compressed difference of two
nearby gradients magnifies that, and the leaves that start at zero (the
norms, the biases, ``dt_bias``) hold a few coordinate medians of such
differences: there the port parts from the reference by up to 4.0e-5 of
the leaf's largest entry (1.6e-8 absolute), where the reference's own two
backends part by 1.1e-5, so the per-leaf relative form of the dense
decoders' test does not apply. A checkpoint of a
bfloat16 state of either tree (Adam's state included) written by either
package loads in the other bit for bit.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JaxRunSpec
from repro.api import run as jax_run
from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch import random as R
from repro_torch.api import RunSpec, run
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.launch import train
from repro_torch.models import init_params
from repro_torch.optim import get_optimizer

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TRAJ_TOL = 2e-5
SSM = ("mamba2-130m", "recurrentgemma-2b")
LM = dict(task="lm", method="marina", p=0.5, n_workers=5, n_byz=1,
          attack="ALIE", aggregator="cm", bucket_size=2, compressor="randk",
          compressor_kwargs={"ratio": 0.1}, lr=3e-3, steps=4,
          data_kwargs={"seq_len": 16, "per_worker_batch": 2,
                       "reduced": True})


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _flat(tree) -> dict:
    return {_path(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def reference_runs():
    return {name: jax_run(JaxRunSpec(**{**LM, "arch": name,
                                        "agg_mode": "gspmd"}), log_every=1)
            for name in SSM}


@pytest.mark.parametrize("mode", ["gspmd", "pallas"])
@pytest.mark.parametrize("name", SSM)
def test_marina_trajectory_against_the_reference(reference_runs, name, mode):
    ref = reference_runs[name]
    got = run(RunSpec(**{**LM, "arch": name, "agg_mode": mode}),
              device="cpu", log_every=1)
    assert got.n_params == ref.n_params
    ck = [int(h["c_k"]) for h in got.history]
    assert ck == [int(h["c_k"]) for h in ref.history]
    assert set(ck) == {0, 1}
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in ref.history],
                               rtol=0, atol=TRAJ_TOL)
    want = _flat(ref.state["params"])
    assert sorted(got.params) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(got.params[k].numpy(), w, rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL, err_msg=k)


@pytest.mark.parametrize("name", SSM)
def test_checkpoint_loads_in_either_package(tmp_path, name):
    """The reduced tree in bfloat16 with Adam's state, written by each
    package and read by the other; the manifests are equal and name the
    block kinds' leaves as the reference does."""
    jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16")
    jp = jax_init(jax.random.PRNGKey(2), jcfg)
    adam = jax_get_optimizer("adam")
    js = jax.jit(adam.update)(jp, adam.init(jp), jp)[1]
    jstate = {"params": jp, "g": jp, "opt_state": js,
              "step": jnp.asarray(4, jnp.int32)}
    tp = init_params(R.PRNGKey(2), cfg)
    like = {"params": tp, "g": dict(tp),
            "opt_state": get_optimizer("adam").init(tp), "step": 0}
    jax_save(str(tmp_path / "ref"), jstate, step=4)
    got, step = load_checkpoint(str(tmp_path / "ref"), like=like)
    want = state_from_numpy(jax.device_get(jstate))
    assert step == 4
    for part in ("params", "g"):
        for k, v in want[part].items():
            assert got[part][k].dtype == torch.bfloat16
            assert torch.equal(got[part][k], v), (part, k)
    for part in ("m", "v"):
        for k, v in want["opt_state"][part].items():
            assert torch.equal(got["opt_state"][part][k], v), (part, k)
    save_checkpoint(str(tmp_path / "port"), got, step=4)
    back, _ = jax_load(str(tmp_path / "port"), like=jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    manifests = [json.loads((tmp_path / f"{w}.json").read_text())
                 for w in ("ref", "port")]
    assert manifests[0] == manifests[1]
    leaf = ("params/groups/[0]/mixer/a_log" if name == SSM[0]
            else "params/groups/[0]/mixer/lam")
    assert leaf in manifests[0]["leaves"]


def test_train_cli_runs_mamba2():
    """``python -m repro_torch.launch.train --arch mamba2-130m --reduced
    --steps 1 --device cpu``, in process: the init's aggregation and one
    round, every loss finite."""
    hist = train.main(["--arch", SSM[0], "--reduced", "--steps", "1",
                       "--device", "cpu", "--seq-len", "16",
                       "--per-worker-batch", "2", "--log-every", "1"])
    assert [h["step"] for h in hist] == [0]
    assert all(np.isfinite(h["loss"]) for h in hist)
