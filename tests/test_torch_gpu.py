"""The CUDA robust-aggregation kernel against its plain PyTorch version, on
the card. Imports no JAX, so it runs where only PyTorch and the CUDA
toolkit are installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test here skips. Tolerance: 1e-5 × max|input|, the
reordered float32 sums of W·x over at most 64 workers."""
import pytest
import torch

from repro_torch import random as R
from repro_torch.core.attacks import CoordAttack
from repro_torch.kernels import norm_agg, quantize
from repro_torch.kernels.robust_agg import robust_agg, robust_agg_plain

TOL = 1e-5
ALIE = CoordAttack("ALIE", 1.06)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, d, dev, s):
    g = torch.Generator(device=dev).manual_seed(n * 1000 + d)
    x = torch.randn(n, d, device=dev, generator=g)
    mean = torch.randn(d, device=dev, generator=g)
    std = torch.rand(d, device=dev, generator=g)
    mask = torch.arange(n, device=dev) < max(1, n // 4)
    w = (norm_agg.bucket_matrix(R.permutation(R.PRNGKey(n, device=dev), n),
                                n, s) if s else None)
    return x, w, mask, mean, std


def _agree(args, **kw):
    got = robust_agg(*args, **kw)
    want = robust_agg_plain(*args, **kw)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=TOL * 4 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [0, 2, 3])
@pytest.mark.parametrize("rule", ["mean", "median", "trimmed"])
@pytest.mark.parametrize("n", [1, 5, 64])
def test_dense(dev, n, rule, s):
    if s > n:
        pytest.skip("bucket larger than the worker count")
    before = robust_agg.launches
    _agree(_inputs(n, 5000, dev, s), rule=rule, attack=ALIE)
    assert robust_agg.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("attack", [None, "BF", "IPM"])
def test_dense_attacks(dev, attack):
    att = None if attack is None else CoordAttack(attack, 0.1)
    _agree(_inputs(16, 3001, dev, 2), rule="median", attack=att)


@pytest.mark.gpu
@pytest.mark.parametrize("base_rows", [0, 1, 8])
@pytest.mark.parametrize("d", [1, 123, 70000])
def test_sparse_wire(dev, d, base_rows):
    n = 8
    _, w, mask, mean, std = _inputs(n, d, dev, 2)
    k = max(int(0.1 * d), 1)
    keys = R.fold_in(R.PRNGKey(d, device=dev), torch.arange(n, device=dev))
    idx = torch.sort(R.permutation(keys, d)[:, :k], dim=1).values.int()
    vals = torch.randn(n, k, device=dev)
    base = torch.randn(base_rows, d, device=dev) if base_rows else None
    src = quantize.WireSrc(fmt="sparse", n=n, d=d,
                           arrays=(("vals", vals), ("idx", idx)), base=base)
    before = robust_agg.wire_launches
    _agree((src, w, mask, mean, std), rule="median", attack=ALIE)
    assert robust_agg.wire_launches == before + 1


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, w, mask, mean, std = _inputs(5, 100, dev, 2)
    with pytest.raises(TypeError):
        robust_agg(x.double(), w, mask, mean, std, attack=ALIE)
    with pytest.raises(ValueError, match="contiguous"):
        robust_agg(torch.randn(100, 5, device=dev).T, w, mask, mean, std,
                   attack=ALIE)
    with pytest.raises(ValueError, match="workers"):
        robust_agg(torch.randn(65, 100, device=dev))
