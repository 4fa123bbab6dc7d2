"""LM training through the port's runner, optimizers, checkpoints, training
CLI and streaming service, against the reference package on the CPU.

Tolerances: a run of the paper's main path on qwen3-1.7b ``reduced()``
(MARINA + RandK 0.1 + ALIE + cm, s = 2) is held to ``repro.api.run`` on
gspmd, the reference jitted as its runner compiles it: losses within
TRAJ_TOL, each parameter leaf within TRAJ_TOL of its largest entry (XLA's
CPU dots sum in another order than torch's; the kernels' plain versions
follow the reference's order). The RN attack's bfloat16 draw, the
checkpoints (bfloat16 leaves, optimizer state), a resumed run and the
service's sync limit are equal, bit for bit. Adam divides the first
moment by the root of the second: where a gradient entry nearly cancels
(a few 1e-8 against terms of 1e-3) the dots' reordering changes its sign
or size, and that coordinate's step moves by a good part of lr; the
next rounds' gradients then start from parameters that differ there.
Under Adam the update itself is held bit for bit on equal inputs, the
losses to TRAJ_TOL, the parameters to ADAM_TOL of the largest distance
the run can move them, lr · steps (7.5e-2 of one step measured), and
the moments to ADAM_MOMENT_TOL of their largest entry (5.9e-5 measured).
"""
from __future__ import annotations

import dataclasses

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
from repro.core.attacks import get_attack as jax_get_attack
from repro.models import init_params as jax_init
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch import random as R
from repro_torch.api import RunSpec, ServeSpec, run
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import key_from_numpy, state_from_numpy
from repro_torch.core.attacks import get_attack
from repro_torch.launch import train
from repro_torch.models import init_params
from repro_torch.optim import get_optimizer

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

TRAJ_TOL = 2e-5
ADAM_TOL = 0.1
ADAM_MOMENT_TOL = 2e-4
LM = dict(task="lm", arch="qwen3-1.7b", method="marina", p=0.1, n_workers=5,
          n_byz=1, attack="ALIE", aggregator="cm", bucket_size=2,
          compressor="randk", compressor_kwargs={"ratio": 0.1}, lr=3e-3,
          steps=3, data_kwargs={"seq_len": 16, "per_worker_batch": 2,
                                "reduced": True})
# the optimizer runs take the one-gradient sgd estimator: the optimizer is
# what they hold, and the reference compiles that step in a third of the
# time of MARINA's two branches
OPT_RUNS = {"sgd": dict(method="sgd", optimizer="sgd",
                        optimizer_kwargs={"momentum": 0.9}),
            "adam": dict(method="sgd", optimizer="adam")}


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _flat(tree) -> dict:
    return {_path(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _held(ref, got, param_atol=None, moment_tol=TRAJ_TOL):
    """Losses within TRAJ_TOL; every parameter leaf within TRAJ_TOL of its
    largest entry (or within ``param_atol``), every optimizer moment
    within ``moment_tol`` of its largest entry."""
    assert [h.get("c_k") for h in got.history] == \
        [h.get("c_k") for h in ref.history]
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in ref.history],
                               rtol=0, atol=TRAJ_TOL)
    trees = [("params", ref.state["params"], got.state["params"])]
    if ref.state["opt_state"]:
        for part in ("m", "v"):
            if part in ref.state["opt_state"]:
                trees.append((part, ref.state["opt_state"][part],
                              got.state["opt_state"][part]))
    for name, want_tree, got_tree in trees:
        want = _flat(want_tree)
        assert sorted(got_tree) == list(want)
        for k, w in want.items():
            err = np.abs(got_tree[k].numpy() - w).max()
            if name != "params":
                limit = moment_tol * np.abs(w).max()
            elif param_atol is not None:
                limit = param_atol
            else:
                limit = TRAJ_TOL * np.abs(w).max()
            assert err <= limit, (name, k, err, limit)


@pytest.fixture(scope="module")
def reference_run():
    return jax_run(JaxRunSpec(**{**LM, "agg_mode": "gspmd"}), log_every=1)


@pytest.mark.parametrize("mode", ["gspmd", "pallas"])
def test_trajectory_against_the_reference(reference_run, mode):
    got = run(RunSpec(**{**LM, "agg_mode": mode}), device="cpu", log_every=1)
    assert got.n_params == reference_run.n_params
    _held(reference_run, got)


@pytest.mark.parametrize("opt", sorted(OPT_RUNS))
def test_optimizer_runs_against_the_reference(opt):
    spec = {**LM, **OPT_RUNS[opt], "agg_mode": "gspmd"}
    ref = jax_run(JaxRunSpec(**spec), log_every=1)
    got = run(RunSpec(**{**spec, "agg_mode": "pallas"}), device="cpu",
              log_every=1)
    if opt == "adam":
        _held(ref, got, ADAM_TOL * spec["lr"] * spec["steps"],
              ADAM_MOMENT_TOL)
    else:
        _held(ref, got)
    if opt == "adam":
        assert int(got.state["opt_state"]["t"]) == \
            int(ref.state["opt_state"]["t"]) == LM["steps"]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_optimizer_update_bit_for_bit(opt):
    """One optimizer step on a bfloat16 tree, the reference jitted."""
    kw = {"lr": 0.01, "weight_decay": 0.1,
          **({"momentum": 0.9} if opt == "sgd" else {})}
    g = np.random.default_rng(0)
    params = {"a": g.standard_normal((3, 4)).astype(np.float32),
              "b": g.standard_normal(7).astype(np.float32)}
    grads = {k: g.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    jopt, topt = jax_get_optimizer(opt, **kw), get_optimizer(opt, **kw)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    tp = {k: torch.as_tensor(v).bfloat16() for k, v in params.items()}
    tg = {k: torch.as_tensor(v) for k, v in grads.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(2):
        jp, js = jax.jit(jopt.update)(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
    for k in params:
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp[k].float().numpy(),
                                      np.asarray(jp[k], np.float32))
        for part in ("m", "v"):
            if part in js:
                np.testing.assert_allclose(ts[part][k].numpy(),
                                           np.asarray(js[part][k]),
                                           rtol=1e-6, atol=0)


def test_random_noise_bf16_bit_for_bit():
    """RN on bfloat16 candidates at 2 x 4099, the reference jitted as its
    runner compiles it: JAX's bfloat16 normal times the scale."""
    key = jax.random.PRNGKey(23)
    h = jnp.zeros((2, 4099), jnp.bfloat16)
    for scale in (10.0, 0.3):
        want = jax.jit(lambda k, x: jax_get_attack("RN", scale=scale).apply(
            k, x, None, None))(key, h)
        got = get_attack("RN", scale=scale).apply(
            key_from_numpy(key), torch.zeros(2, 4099, dtype=torch.bfloat16),
            None, None)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


def _bf16_states():
    """One LM engine state in each package: bfloat16 parameters of
    qwen3-1.7b reduced, g, Adam's moments and count, the step."""
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="bfloat16")
    jp = jax_init(jax.random.PRNGKey(2), jcfg)
    adam = jax_get_optimizer("adam")
    js = jax.jit(adam.update)(jp, adam.init(jp), jp)[1]
    jstate = {"params": jp, "g": jp, "opt_state": js,
              "step": jnp.asarray(7, jnp.int32)}
    tp = init_params(R.PRNGKey(2), cfg)
    tstate = {"params": tp, "g": dict(tp),
              "opt_state": get_optimizer("adam").init(tp), "step": 0}
    return jstate, tstate


def test_lm_checkpoints_load_in_either_package(tmp_path):
    """A bfloat16 LM state with Adam's state, written by either package,
    loads in the other equal to the state written; the manifests' keys
    are the reference's (``params/groups/[0]/mixer/wq``)."""
    import json
    jstate, like = _bf16_states()
    jax_save(str(tmp_path / "ref"), jstate, step=7)
    got, step = load_checkpoint(str(tmp_path / "ref"), like=like)
    want = state_from_numpy(jax.device_get(jstate))
    assert step == 7
    for part in ("params", "g"):
        for k, v in want[part].items():
            assert got[part][k].dtype == torch.bfloat16
            assert torch.equal(got[part][k], v), (part, k)
    for part in ("m", "v"):
        for k, v in want["opt_state"][part].items():
            assert torch.equal(got["opt_state"][part][k], v)
    assert torch.equal(got["opt_state"]["t"], want["opt_state"]["t"])
    save_checkpoint(str(tmp_path / "port"), got, step=7)
    back, _ = jax_load(str(tmp_path / "port"), like=jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    manifests = [json.loads((tmp_path / f"{w}.json").read_text())
                 for w in ("ref", "port")]
    assert manifests[0] == manifests[1]
    assert "params/groups/[0]/mixer/wq" in manifests[0]["leaves"]


_CLI = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
        "--seq-len", "16", "--per-worker-batch", "2", "--n-workers", "5",
        "--n-byz", "1", "--attack", "ALIE", "--agg", "cm", "--bucket-size",
        "2", "--compress-ratio", "0.1", "--agg-mode", "pallas", "--opt",
        "adam", "--log-every", "1"]


def test_resume_through_train_cli_flags(tmp_path):
    """The twin of the reference's test of the same name, driven through
    the CLI: 1 round checkpointed, resumed to 3 with ``--resume``, equal
    to 3 uninterrupted rounds bit for bit (Adam's state included)."""
    args = train.build_parser().parse_args(
        ["--steps", "4", "--resume", "foo/ck", "--checkpoint-every", "2"])
    assert args.resume == "foo/ck"
    assert args.checkpoint_every == 2
    half, resumed, whole = (str(tmp_path / n) for n in ("half", "res", "all"))
    train.main(_CLI + ["--steps", "1", "--checkpoint", half])
    hist = train.main(_CLI + ["--steps", "3", "--resume", half,
                              "--checkpoint", resumed])
    full = train.main(_CLI + ["--steps", "3", "--checkpoint", whole])
    assert [h["step"] for h in hist] == [1, 2]
    assert [h["loss"] for h in hist] == [h["loss"] for h in full[1:]]
    with np.load(resumed + ".npz") as a, np.load(whole + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])


def test_train_cli_lists_every_arch_and_refuses_unported(capsys):
    train.main(["--list-components"])
    out = capsys.readouterr().out
    for name in ("qwen3-1.7b", "mamba2-130m", "deepseek-v2-lite-16b",
                 "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b",
                 "musicgen-medium", "qwen2-vl-2b", "llama3-405b",
                 "mistral-large-123b", "starcoder2-3b"):
        assert f"  {name} " in out
    hist = train.main(_CLI + ["--arch", "recurrentgemma-2b", "--steps", "1"])
    assert [h["step"] for h in hist] == [0]
    assert all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("mode", ["gspmd", "pallas"])
def test_lm_service_sync_limit_is_the_synchronous_run(mode):
    """At K = n, constant latency and no chaos the service over the LM
    task is the synchronous run of its RunSpec, bit for bit."""
    spec = ServeSpec(task="lm", arch="qwen3-1.7b", method="sgd", n_clients=5,
                     n_byz=1, attack="ALIE", aggregator="cm", buffer_size=5,
                     rounds=3, lr=3e-3, arrival="const", seed=3,
                     bucket_size=2, agg_mode=mode,
                     data_kwargs={"seq_len": 16, "per_worker_batch": 2,
                                  "reduced": True})
    res = spec.run(device="cpu")
    sync = spec.to_run_spec().run(device="cpu", log_every=1)
    assert sorted(res.params) == sorted(sync.state["params"])
    for k, v in res.params.items():
        assert torch.equal(v, sync.state["params"][k]), k
    assert [m["loss"] for m in res.history] == \
        [m["loss"] for m in sync.history]
    assert res.stats["rounds"] == 3
