"""The CUDA aggregation kernels against their plain PyTorch versions, on
the card. Imports no JAX, so it runs where only PyTorch and the CUDA
toolkit are installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test here skips. Tolerances: 1e-5 × max|input| for
the coordinate rules, RFA's z and the weighted sum (reordered float32
sums of W·x over at most 64 workers); 1e-5 of the largest entry for the
Gram and the squared distances, sums over d taken in another order; bit
for bit for the blocked weighted sum, whose kernel takes the plain
version's order. The norm kernels must also repeat bit for bit: they take
every sum in a fixed order. TopK's select kernels and the block quantizer
agree with their plain versions exactly: selection only compares, and
the quantizer takes every rounding of the plain version."""
import dataclasses

import pytest
import torch

from repro_torch import random as R
from repro_torch.core.attacks import CoordAttack
from repro_torch.kernels import norm_agg, quantize
from repro_torch.kernels.robust_agg import robust_agg, robust_agg_plain
from repro_torch.kernels.quantize import (block_quantize,
                                          block_quantize_plain, topk_select,
                                          topk_select_plain, topk_support,
                                          topk_support_plain)

NORM = {"pair_gram": norm_agg.pair_gram, "rfa_iter": norm_agg.rfa_iter,
        "weighted_sum": norm_agg.weighted_sum}
BLOCKED = {name: getattr(norm_agg, name) for name in (
    "pair_gram_blocked", "sqdist_to_blocked", "weighted_sum_blocked")}

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
    before = robust_agg.load_launches["sparse"]
    _agree((src, w, mask, mean, std), rule="median", attack=ALIE)
    assert robust_agg.load_launches["sparse"] == before + 1


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


def _wire(n, d, dev, base_rows, fmt="sparse", cand=torch.float32):
    """A worker-stacked payload of ``fmt`` made on the card: RandK 0.1 for
    the sparse wire, else the packer of the format over random rows."""
    keys = R.fold_in(R.PRNGKey(d, device=dev), torch.arange(n, device=dev))
    base = torch.randn(base_rows, d, device=dev) if base_rows else None
    if fmt == "sparse":
        k = max(int(0.1 * d), 1)
        idx = torch.sort(R.permutation(keys, d)[:, :k], dim=1).values.int()
        arrays = (("vals", torch.randn(n, k, device=dev)), ("idx", idx))
    else:
        x = torch.randn(n, d, device=dev) * torch.rand(n, d, device=dev)
        arrays = tuple(quantize.PACK[fmt](keys, x).items())
    return quantize.WireSrc(fmt=fmt, n=n, d=d, arrays=arrays, base=base,
                            cand_dtype=cand)


LOADS = ("dense", "wire", "dense_bf16", "int8", "sign", "bf16")


def _load(load, x, dev, base_rows=1):
    """The kernel input of ``load`` for the dense stack x (n, d): x itself,
    x in bfloat16, or a wire payload with a base of ``base_rows``."""
    n, d = x.shape
    if load == "dense":
        return x
    if load == "dense_bf16":
        return x.bfloat16()
    return _wire(n, d, dev, base_rows, "sparse" if load == "wire" else load)


@pytest.mark.gpu
@pytest.mark.parametrize("cand", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("base_rows", [0, 1, 8])
@pytest.mark.parametrize("d", [1, 123, 5000, 70000])
@pytest.mark.parametrize("fmt", ["sparse", "int8", "sign", "bf16"])
def test_wire_loads(dev, fmt, d, base_rows, cand):
    """Each wire load with its base and candidate dtype, ALIE fused, against
    ``quantize.recon`` and the plain rule: equal without W (the load takes
    every rounding of the plain reconstruction), to the tolerance with
    it; and the four kernels through ``_norm_agree``."""
    n = 8
    _, w, mask, mean, std = _inputs(n, d, dev, 2)
    src = _wire(n, d, dev, base_rows, fmt, cand)
    before = robust_agg.load_launches[fmt]
    got = robust_agg(src, None, mask, mean, std, rule="median", attack=ALIE)
    want = robust_agg_plain(src, None, mask, mean, std, rule="median",
                            attack=ALIE)
    torch.cuda.synchronize()
    assert robust_agg.load_launches[fmt] == before + 1
    assert torch.equal(got, want)
    _agree((src, w, mask, mean, std), rule="median", attack=ALIE)
    _norm_agree(src, w, mask, mean, std)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("n", [1, 5, 64])
def test_dense_bf16_stack(dev, n, s):
    """A bfloat16 stack with ALIE on its byzantine rows: the forged value
    rounds through bfloat16 before the select, in the kernel as in the
    plain version."""
    if s > n:
        pytest.skip("bucket larger than the worker count")
    x, w, mask, mean, std = _inputs(n, 5000, dev, s)
    xb = x.bfloat16()
    before = robust_agg.load_launches["dense_bf16"]
    got = robust_agg(xb, None, mask, mean, std, rule="median", attack=ALIE)
    want = robust_agg_plain(xb, None, mask, mean, std, rule="median",
                            attack=ALIE)
    torch.cuda.synchronize()
    assert robust_agg.load_launches["dense_bf16"] == before + 1
    assert torch.equal(got, want)
    _agree((xb, w, mask, mean, std), rule="median", attack=ALIE)
    _norm_agree(xb, w, mask, mean, std)


def _near(got, want, scale):
    assert got.shape == want.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=TOL * max(1.0, scale))


def _norm_agree(x, w, mask, mean, std):
    """Each norm kernel against its plain version, twice, bit for bit."""
    n = norm_agg.src_dims(x)[0]
    m = n if w is None else w.shape[0]
    g = torch.Generator(device=mask.device).manual_seed(m)
    wr = torch.rand(m, device=mask.device, generator=g) + 0.1
    wr = wr / wr.sum()
    wn = torch.rand(n, device=mask.device, generator=g)
    sent = norm_agg.prologue(norm_agg.stack(x), None, mask, mean, std, ALIE)
    scale = float(sent.abs().max())
    before = {k: fn.launches for k, fn in NORM.items()}
    gram = [norm_agg.pair_gram(x, w, mask, mean, std, attack=ALIE)
            for _ in range(2)]
    rfa = [norm_agg.rfa_iter(x, wr, w, mask, mean, std, attack=ALIE)
           for _ in range(2)]
    ws = [norm_agg.weighted_sum(x, wn, mask, mean, std, attack=ALIE)
          for _ in range(2)]
    torch.cuda.synchronize()
    assert {k: fn.launches - before[k] for k, fn in NORM.items()} == {
        k: 2 for k in NORM}
    assert torch.equal(gram[0], gram[1]) and torch.equal(ws[0], ws[1])
    assert torch.equal(rfa[0][0], rfa[1][0]) and torch.equal(rfa[0][1],
                                                             rfa[1][1])
    want = norm_agg.pair_gram_plain(x, w, mask, mean, std, attack=ALIE)
    _near(gram[0], want, float(want.abs().max()))
    assert torch.equal(gram[0], gram[0].T)
    z, sq = norm_agg.rfa_iter_plain(x, wr, w, mask, mean, std, attack=ALIE)
    _near(rfa[0][0], z, scale)
    _near(rfa[0][1], sq, float(sq.max()))
    _near(ws[0], norm_agg.weighted_sum_plain(x, wn, mask, mean, std,
                                             attack=ALIE), scale)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [0, 2, 3])
@pytest.mark.parametrize("n", [1, 5, 64])
@pytest.mark.parametrize("load", ["dense", "wire"])
def test_norm_kernels(dev, load, n, s):
    if s > n:
        pytest.skip("bucket larger than the worker count")
    x, w, mask, mean, std = _inputs(n, 5000, dev, s)
    if load == "wire":
        x = _wire(n, 5000, dev, 1)
    _norm_agree(x, w, mask, mean, std)


@pytest.mark.gpu
@pytest.mark.parametrize("base_rows", [0, 1, 8])
@pytest.mark.parametrize("d", [1, 123, 70000])
def test_norm_kernels_sparse_wire(dev, d, base_rows):
    _, w, mask, mean, std = _inputs(8, d, dev, 2)
    _norm_agree(_wire(8, d, dev, base_rows), w, mask, mean, std)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(NORM))
def test_norm_wrappers_reject_what_the_kernels_do_not_take(dev, name):
    x, w, mask, mean, std = _inputs(5, 100, dev, 2)
    wts = torch.full((3 if name == "rfa_iter" else 5,), 0.2, device=dev)
    fn = NORM[name]
    call = ((lambda a: fn(a, w, mask, mean, std, attack=ALIE))
            if name == "pair_gram" else
            (lambda a: fn(a, wts, w, mask, mean, std, attack=ALIE))
            if name == "rfa_iter" else
            (lambda a: fn(a, wts, mask, mean, std, attack=ALIE)))
    with pytest.raises(TypeError):
        call(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.randn(100, 5, device=dev).T)
    with pytest.raises(ValueError, match="workers"):
        fn(*((torch.randn(65, 100, device=dev),)
             + (() if name == "pair_gram" else
                (torch.full((65,), 1 / 65, device=dev),))))


def _blocked_inputs(m, d, dev):
    g = torch.Generator(device=dev).manual_seed(m * 7919 + d)
    return (torch.randn(m, d, device=dev, generator=g),
            torch.randn(d, device=dev, generator=g),
            torch.rand(m, device=dev, generator=g))


@pytest.mark.gpu
@pytest.mark.parametrize("m, d", [(m, d) for m in (65, 75, 130, 150)
                                  for d in (1, 123, 2100)]
                         + [(4096, 256)])
def test_blocked_kernels(dev, m, d):
    """Each blocked kernel against its plain version, twice, bit for bit;
    the Gram symmetric bit for bit."""
    x, z, w = _blocked_inputs(m, d, dev)
    before = {k: fn.launches for k, fn in BLOCKED.items()}
    gram = [norm_agg.pair_gram_blocked(x) for _ in range(2)]
    sq = [norm_agg.sqdist_to_blocked(x, z) for _ in range(2)]
    ws = [norm_agg.weighted_sum_blocked(x, w) for _ in range(2)]
    torch.cuda.synchronize()
    assert {k: fn.launches - before[k] for k, fn in BLOCKED.items()} == {
        k: 2 for k in BLOCKED}
    for pair in (gram, sq, ws):
        assert torch.equal(pair[0], pair[1])
    assert torch.equal(gram[0], gram[0].T)
    want = norm_agg.pair_gram_blocked_plain(x)
    _near(gram[0], want, float(want.abs().max()))
    want = norm_agg.sqdist_to_blocked_plain(x, z)
    _near(sq[0], want, float(want.max()))
    assert torch.equal(ws[0], norm_agg.weighted_sum_blocked_plain(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(BLOCKED))
def test_blocked_wrappers_reject_what_the_kernels_do_not_take(dev, name):
    x, z, w = _blocked_inputs(70, 100, dev)
    fn = BLOCKED[name]
    extra = {"pair_gram_blocked": (), "sqdist_to_blocked": (z,),
             "weighted_sum_blocked": (w,)}[name]
    with pytest.raises(TypeError):
        fn(x.double(), *extra)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.randn(100, 70, device=dev).T, *extra)
    with pytest.raises(ValueError, match="stack"):
        fn(x[0], *extra)
    if extra:
        with pytest.raises(ValueError, match="shape"):
            fn(x, extra[0][:-1])
    if name == "weighted_sum_blocked":
        with pytest.raises(ValueError, match="more than 64 rows"):
            fn(x[:64], w[:64])


def _topk_input(rows, d, dev, ties):
    g = torch.Generator(device=dev).manual_seed(rows * 7919 + d)
    if ties:
        return torch.randint(-3, 4, (rows, d), device=dev,
                             generator=g).float()
    return torch.randn(rows, d, device=dev, generator=g)


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("rows, d, k", [(5, 5000, 500), (5, 4097, 1),
                                        (3, 12289, 4097), (2, 16384, 16384),
                                        (3, 70000, 7000),
                                        (2, (1 << 16) + 3, 3000),
                                        (1, 1 << 20, 104857),
                                        (1, 1 << 22, 1),
                                        (1, 1 << 22, (1 << 22) - 1)])
def test_topk_select(dev, rows, d, k, ties):
    """The select kernels equal their plain twins exactly and repeat bit
    for bit: ``topk_support`` (ascending indices, and the values at them)
    and ``topk_select`` (the plain version's indices in order; the whole
    row kept at 2 x 16384)."""
    x = _topk_input(rows, d, dev, ties)
    before = topk_select.launches
    sup = [topk_support(x, k) for _ in range(2)]
    got = topk_select(x, k)
    torch.cuda.synchronize()
    assert topk_select.launches == before + 3
    idx, vals = sup[0]
    assert idx.dtype == torch.int32 and idx.shape == (rows, k)
    assert torch.equal(idx, sup[1][0]) and torch.equal(vals, sup[1][1])
    assert torch.equal(idx, topk_support_plain(x, k)[0])
    assert torch.equal(vals, torch.gather(x, 1, idx.long()))
    assert torch.equal(got, topk_select_plain(x, k))
    assert torch.equal(idx, torch.sort(got, dim=1).values)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [5000, 70000])
def test_topk_select_orders_nan_and_signed_zeros(dev, d):
    """NaN of any sign or payload above +inf, ties among NaNs and between
    +0 and -0 to the lower index, runs of equal keys across the digits'
    boundaries."""
    g = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn(3, d, device=dev, generator=g)
    x[0, torch.randint(0, d, (50,), device=dev, generator=g)] = float("nan")
    x[0, 7] = float("inf")
    x[0, 11] = -float("nan")
    x[1] = torch.where(torch.rand(d, device=dev, generator=g) < 0.5, 0.0,
                       -0.0)
    x[1, :40] = 1.0
    bits = torch.full((d,), 0x3FC00000, dtype=torch.int32, device=dev)
    bits += torch.randint(-1100, 1100, (d,), device=dev, generator=g,
                          dtype=torch.int32)
    x[2] = bits.view(torch.float32) * torch.where(
        torch.rand(d, device=dev, generator=g) < 0.5, -1.0, 1.0)
    for k in (1, 45, d // 10, d // 2, d - 1, d):
        assert torch.equal(topk_select(x, k), topk_select_plain(x, k))
        assert torch.equal(topk_support(x, k)[0],
                           topk_support_plain(x, k)[0])


@pytest.mark.gpu
def test_topk_select_takes_no_kernel_up_to_two_tiles(dev):
    x = _topk_input(4, 4096, dev, True)
    before = topk_select.launches
    got = topk_select(x, 409)
    assert topk_select.launches == before
    assert torch.equal(got.cpu(), topk_select_plain(x.cpu(), 409))


@pytest.mark.gpu
def test_topk_select_rejects_what_the_kernel_does_not_take(dev):
    x = _topk_input(2, 5000, dev, False)
    for k in (0, 5001):
        with pytest.raises(ValueError, match="outside"):
            topk_select(x, k)
        with pytest.raises(ValueError, match="outside"):
            topk_support(x, k)
    with pytest.raises(ValueError, match="d >"):
        quantize._launch_topk(x[:, :4096].contiguous(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        quantize._launch_topk(_topk_input(5000, 2, dev, False).T, 5)


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [1, 3, 4, 16])
@pytest.mark.parametrize("d", [1, 255, 1000, 2048, 5000, 70000])
def test_block_quantize(dev, d, levels):
    """Kernel against plain version, bit for bit, and twice."""
    g = torch.Generator(device=dev).manual_seed(d + levels)
    x = torch.randn(d, device=dev, generator=g) * torch.rand(
        d, device=dev, generator=g) * 10
    x[torch.rand(d, device=dev, generator=g) < 0.05] = 0.0
    u = torch.rand(d, device=dev, generator=g)
    before = block_quantize.launches
    got = [block_quantize(x, u, levels=levels) for _ in range(2)]
    torch.cuda.synchronize()
    assert block_quantize.launches == before + 2
    want = block_quantize_plain(x, u, levels=levels)
    assert torch.equal(got[0], got[1])
    assert int((got[0] != want).sum()) == 0
    assert torch.equal(got[0].cpu(),
                       block_quantize_plain(x.cpu(), u.cpu(), levels=levels))


@pytest.mark.gpu
def test_block_quantize_rejects_what_the_kernel_does_not_take(dev):
    x = torch.randn(300, device=dev)
    with pytest.raises(ValueError, match="vector"):
        block_quantize(x.reshape(3, 100), x.reshape(3, 100))
    with pytest.raises(ValueError, match="shape"):
        block_quantize(x, x[:-1])
    with pytest.raises(ValueError, match="levels"):
        block_quantize(x, x, levels=0)


def _masked(n, s, dev, invalid):
    """(valid, W, bvalid): rows ``invalid`` dropped, and the masked bucket
    operator over a fixed permutation when s > 1."""
    from repro_torch.faults.guard import masked_bucket_matrix
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[list(invalid)] = False
    if not s:
        return valid, None, valid
    perm = R.permutation(R.PRNGKey(n, device=dev), n)
    w, bvalid = masked_bucket_matrix(perm, n, s, valid)
    return valid, w, bvalid


def _poison(x, valid):
    """NaN into the invalid rows of a dense stack, or of every float array
    of a wire payload (values, norms, scale): the load must zero them with
    a select, so nothing of them reaches the result."""
    if isinstance(x, quantize.WireSrc):
        arrays = []
        for name, a in x.arrays:
            if a.is_floating_point():
                a = a.clone()
                a[~valid] = float("nan")
            arrays.append((name, a))
        return dataclasses.replace(x, arrays=tuple(arrays))
    x = x.clone()
    x[~valid] = float("nan")
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("load", LOADS)
@pytest.mark.parametrize("s", [0, 2, 3])
@pytest.mark.parametrize("rule", ["mean", "median", "trimmed"])
@pytest.mark.parametrize("n", [5, 8, 64])
def test_masked_robust_agg(dev, n, rule, s, load):
    """The masked rule equals its plain version (``torch.equal``: the
    kernel and the plain version both read a rank as 0 + v)."""
    x, _, mask, mean, std = _inputs(n, 5000, dev, 0)
    x = _load(load, x, dev)
    valid, w, bvalid = _masked(n, s, dev, range(n - 2, n))
    x = _poison(x, valid)
    before = robust_agg.masked_launches
    kind = load if load != "wire" else "sparse"
    before_load = robust_agg.masked_load_launches[kind]
    args = (x, w, mask, mean, std, valid, bvalid)
    got = robust_agg(*args, rule=rule, attack=ALIE)
    want = robust_agg_plain(*args, rule=rule, attack=ALIE)
    torch.cuda.synchronize()
    assert robust_agg.masked_launches == before + 1
    assert robust_agg.masked_load_launches[kind] == before_load + 1
    assert torch.isfinite(got).all()
    if s == 3:       # W x: the plain version's matmul sums in another order
        torch.testing.assert_close(got, want, rtol=0, atol=TOL * 4 * max(
            1.0, float(want.abs().max())))
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [0, 2, 3])
@pytest.mark.parametrize("n", [5, 8, 64])
@pytest.mark.parametrize("load", LOADS)
def test_masked_norm_kernels(dev, load, n, s):
    """pair_gram / rfa_iter / weighted_sum with a validity mask against
    their plain versions, at the unmasked cases' tolerances, and bit for
    bit twice."""
    x, _, mask, mean, std = _inputs(n, 5000, dev, 0)
    x = _load(load, x, dev, 1 if load in ("wire", "int8") else n)
    valid, w, _ = _masked(n, s, dev, [n - 1])
    x = _poison(x, valid)
    m = n if w is None else w.shape[0]
    wr = torch.full((m,), 1.0 / m, device=dev)
    wn = torch.rand(n, device=dev)
    before = {k: fn.masked_launches for k, fn in NORM.items()}
    gram = [norm_agg.pair_gram(x, w, mask, mean, std, valid, attack=ALIE)
            for _ in range(2)]
    rfa = [norm_agg.rfa_iter(x, wr, w, mask, mean, std, valid, attack=ALIE)
           for _ in range(2)]
    ws = [norm_agg.weighted_sum(x, wn, mask, mean, std, valid, attack=ALIE)
          for _ in range(2)]
    torch.cuda.synchronize()
    assert {k: fn.masked_launches - before[k] for k, fn in NORM.items()} == {
        k: 2 for k in NORM}
    assert torch.equal(gram[0], gram[1]) and torch.equal(ws[0], ws[1])
    assert all(torch.equal(a, b) for a, b in zip(rfa[0], rfa[1]))
    sent = norm_agg.prologue(norm_agg.stack(x), None, mask, mean, std, ALIE,
                             valid, norm_agg.cand_dtype(x))
    scale = float(sent.abs().max())
    want = norm_agg.pair_gram_plain(x, w, mask, mean, std, valid,
                                    attack=ALIE)
    _near(gram[0], want, float(want.abs().max()))
    z, sq = norm_agg.rfa_iter_plain(x, wr, w, mask, mean, std, valid,
                                    attack=ALIE)
    _near(rfa[0][0], z, scale)
    _near(rfa[0][1], sq, float(sq.max()))
    _near(ws[0], norm_agg.weighted_sum_plain(x, wn, mask, mean, std, valid,
                                             attack=ALIE), scale)


@pytest.mark.gpu
def test_garbled_wire_rows_are_dropped(dev):
    """A row whose indices are garbled (out of range, not ascending) and
    marked invalid leaves the result untouched: the kernel skips its
    scatter and zeroes it, as the plain version does."""
    n, d = 8, 5000
    x = _wire(n, d, dev, 1)
    arr = dict(x.arrays)
    idx = arr["idx"].clone()
    idx[3] = torch.randint(-2 ** 31, 2 ** 31 - 1, idx[3].shape, device=dev,
                           dtype=torch.int64).int()
    bad = quantize.WireSrc(fmt="sparse", n=n, d=d,
                           arrays=(("vals", arr["vals"]), ("idx", idx)),
                           base=x.base)
    _, _, mask, mean, std = _inputs(n, d, dev, 0)
    valid, w, bvalid = _masked(n, 2, dev, [3])
    got = robust_agg(bad, w, mask, mean, std, valid, bvalid, rule="median",
                     attack=ALIE)
    want = robust_agg_plain(x, w, mask, mean, std, valid, bvalid,
                            rule="median", attack=ALIE)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# The looping kernels (robust_agg and weighted_sum): every load, masked
# and unmasked, every rule, across the register path's row bounds (m <= 4,
# 8, 16) and the shared-memory path (m > 16, a sparse wire of n > 16 rows),
# on ragged widths (vector loads of 4 to 16 columns fall back to scalar
# loads at the edge; int8's norm index c >> 8 inside a vector).
LOOP_N = [1, 5, 8, 17, 33, 64]
RAGGED_D = [1, 123, 5000, (1 << 22) + 3]


def _loop_case(load, n, d, s, masked, dev):
    """(args, plain_equal): a kernel call's (x, W, mask, mean, std, valid,
    bvalid), the last worker invalid and poisoned when ``masked`` (n > 1),
    and whether the kernel must equal its plain version (no W, or the
    masked operator's two members a bucket) rather than agree to TOL."""
    x, w, mask, mean, std = _inputs(n, d, dev, s)
    x = _load(load, x, dev, 1 if load in ("wire", "int8") else n)
    if not masked:
        return (x, w, mask, mean, std, None, None), w is None
    valid, w, bvalid = _masked(n, s, dev, [n - 1] if n > 1 else [])
    return (_poison(x, valid), w, mask, mean, std, valid, bvalid), True


def _big(d, n, rule="median"):
    return d > 1_000_000 and (rule != "median" or n not in (5, 17, 64))


@pytest.mark.gpu
@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("n", LOOP_N)
@pytest.mark.parametrize("rule", ["mean", "median", "trimmed"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("load", LOADS)
def test_robust_agg_looping(dev, load, masked, rule, n, s, d):
    """Equal to the plain version without W and at every masked shape;
    within TOL through W; bit for bit run to run."""
    if s > n:
        pytest.skip("bucket larger than the worker count")
    if _big(d, n, rule):
        pytest.skip("the widest d runs the median at n = 5, 17, 64 only")
    args, equal = _loop_case(load, n, d, s, masked, dev)
    kind = "sparse" if load == "wire" else load
    before = robust_agg.load_launches[kind]
    got = robust_agg(*args, rule=rule, attack=ALIE)
    again = robust_agg(*args, rule=rule, attack=ALIE)
    want = robust_agg_plain(*args, rule=rule, attack=ALIE)
    torch.cuda.synchronize()
    assert robust_agg.load_launches[kind] == before + 2
    assert got.shape == (d,) and torch.equal(got, again)
    if equal:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=TOL * 4 * max(
            1.0, float(want.abs().max())))


@pytest.mark.gpu
@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("n", LOOP_N)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("load", LOADS)
def test_weighted_sum_looping(dev, load, masked, n, d):
    """Within TOL of the plain version (weighted_col's order, one fused
    multiply-add a row up to 32 rows, XLA's two windows above), bit for
    bit run to run."""
    if _big(d, n):
        pytest.skip("the widest d runs at n = 5, 17, 64 only")
    args, _ = _loop_case(load, n, d, 0, masked, dev)
    x, _, mask, mean, std, valid, _ = args
    wn = torch.rand(n, device=dev) + 0.1
    kind = "sparse" if load == "wire" else load
    before = norm_agg.weighted_sum.load_launches[kind]
    got = norm_agg.weighted_sum(x, wn, mask, mean, std, valid, attack=ALIE)
    again = norm_agg.weighted_sum(x, wn, mask, mean, std, valid, attack=ALIE)
    want = norm_agg.weighted_sum_plain(x, wn, mask, mean, std, valid,
                                       attack=ALIE)
    torch.cuda.synchronize()
    assert norm_agg.weighted_sum.load_launches[kind] == before + 2
    assert torch.equal(got, again)
    sent = norm_agg.prologue(norm_agg.stack(x), None, mask, mean, std, ALIE,
                             valid, norm_agg.cand_dtype(x))
    _near(got, want, float(sent.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("s", [0, 2, 3])
@pytest.mark.parametrize("n", LOOP_N)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("load", LOADS)
def test_pair_gram_one_launch(dev, load, masked, n, s, d):
    """One launch a call on every load, masked and unmasked, on every path
    by m (pair products in registers up to 8 bucketed rows, 8 x 8 tiles
    above): symmetric and repeated bit for bit, within tolerance of the
    plain version."""
    if s > n:
        pytest.skip("bucket larger than the worker count")
    if _big(d, n):
        pytest.skip("the widest d runs at n = 5, 17, 64 only")
    args, _ = _loop_case(load, n, d, s, masked, dev)
    x, w, mask, mean, std, valid, _ = args
    kind = "sparse" if load == "wire" else load
    before = norm_agg.pair_gram.load_launches[kind]
    got = norm_agg.pair_gram(x, w, mask, mean, std, valid, attack=ALIE)
    again = norm_agg.pair_gram(x, w, mask, mean, std, valid, attack=ALIE)
    want = norm_agg.pair_gram_plain(x, w, mask, mean, std, valid,
                                    attack=ALIE)
    torch.cuda.synchronize()
    assert norm_agg.pair_gram.load_launches[kind] == before + 2
    m = n if w is None else w.shape[0]
    assert got.shape == (m, m) and torch.equal(got, again)
    assert torch.equal(got, got.T)
    # sums over d in another order: 1e-5 of the largest entry, 1e-4 past
    # a million columns (chip_smoke.py's SUM_TOL and WIDE_SUM_TOL)
    tol = 1e-4 if d > 1_000_000 else TOL
    torch.testing.assert_close(got, want, rtol=0,
                               atol=tol * max(1.0, float(want.abs().max())))


@pytest.mark.gpu
@pytest.mark.parametrize("n, s", [(8, 2), (17, 2), (64, 2), (64, 3)])
def test_pair_gram_takes_every_worker_where_a_column_is_not_finite(dev, n,
                                                                   s):
    """W x skips the workers of zero weight only where a column is
    finite: a column holding inf or NaN takes every worker, so 0 * inf
    spreads NaN to every bucket as ``w_mat @ x`` spreads it."""
    x, w, mask, mean, std = _inputs(n, 5000, dev, s)
    x[3, 100] = float("inf")
    x[n - 1, 200] = float("nan")
    got = norm_agg.pair_gram(x, w, mask, mean, std, attack=ALIE)
    want = norm_agg.pair_gram_plain(x, w, mask, mean, std, attack=ALIE)
    torch.cuda.synchronize()
    assert torch.isnan(got).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    if fin.any():
        torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=TOL * max(
            1.0, float(want[fin].abs().max())))


@pytest.mark.gpu
@pytest.mark.parametrize("n, s", [(8, 2), (64, 2)])
def test_pair_gram_on_two_streams(dev, n, s):
    """Launches in flight on two streams at once keep their own tickets
    (a buffer for each stream), so each Gram of a grid of many blocks
    equals the one-stream call bit for bit, and so does a later call on
    the first stream."""
    x, w, mask, mean, std = _inputs(n, 1 << 21, dev, s)
    want = norm_agg.pair_gram(x, w, mask, mean, std, attack=ALIE)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    got = []
    for _ in range(6):
        for st in streams:
            with torch.cuda.stream(st):
                got.append(norm_agg.pair_gram(x, w, mask, mean, std,
                                              attack=ALIE))
    torch.cuda.synchronize()
    for g in got:
        assert torch.equal(g, want)
    assert torch.equal(norm_agg.pair_gram(x, w, mask, mean, std,
                                          attack=ALIE), want)


@pytest.mark.gpu
@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("s", [0, 2, 3])
@pytest.mark.parametrize("n", LOOP_N)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("load", LOADS)
def test_rfa_iter_one_launch(dev, load, masked, n, s, d):
    """One launch a call on every load, masked and unmasked, on every path
    by m (z and the distances in registers up to 8 bucketed rows, from the
    staged rows above): z and sq repeated bit for bit and within tolerance
    of the plain version (z: TOL of the largest attacked value; sq: TOL of
    the largest distance, 1e-4 past a million columns, chip_smoke.py's
    SUM_TOL and WIDE_SUM_TOL), and the drivers' sq-alone call (no z
    written) equal to the public call's sq."""
    if s > n:
        pytest.skip("bucket larger than the worker count")
    if _big(d, n):
        pytest.skip("the widest d runs at n = 5, 17, 64 only")
    args, _ = _loop_case(load, n, d, s, masked, dev)
    x, w, mask, mean, std, valid, _ = args
    m = n if w is None else w.shape[0]
    wr = torch.rand(m, device=dev, generator=torch.Generator(
        device=dev).manual_seed(m)) + 0.1
    wr = wr / wr.sum()
    kind = "sparse" if load == "wire" else load
    before = norm_agg.rfa_iter.load_launches[kind]
    got = norm_agg.rfa_iter(x, wr, w, mask, mean, std, valid, attack=ALIE)
    again = norm_agg.rfa_iter(x, wr, w, mask, mean, std, valid, attack=ALIE)
    sq_alone = norm_agg._rfa_sq(x, wr, w, mask, mean, std, valid,
                                attack=ALIE)
    z, sq = norm_agg.rfa_iter_plain(x, wr, w, mask, mean, std, valid,
                                    attack=ALIE)
    torch.cuda.synchronize()
    assert norm_agg.rfa_iter.load_launches[kind] == before + 3
    assert got[0].shape == (d,) and got[1].shape == (m,)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(sq_alone, got[1])
    sent = norm_agg.prologue(norm_agg.stack(x), None, mask, mean, std, ALIE,
                             valid, norm_agg.cand_dtype(x))
    _near(got[0], z, float(sent.abs().max()))
    tol = 1e-4 if d > 1_000_000 else TOL
    assert torch.isfinite(got[1]).all()
    torch.testing.assert_close(got[1], sq, rtol=0,
                               atol=tol * max(1.0, float(sq.max())))


@pytest.mark.gpu
@pytest.mark.parametrize("n, s", [(8, 2), (17, 2), (64, 2), (64, 3)])
def test_rfa_iter_takes_every_worker_where_a_column_is_not_finite(dev, n, s):
    """As the Gram's: W x skips the workers of zero weight only where a
    column is finite, so NaN reaches z and sq where ``w_mat @ x`` spreads
    it."""
    x, w, mask, mean, std = _inputs(n, 5000, dev, s)
    x[3, 100] = float("inf")
    x[n - 1, 200] = float("nan")
    wr = torch.full((w.shape[0],), 1.0 / w.shape[0], device=dev)
    got = norm_agg.rfa_iter(x, wr, w, mask, mean, std, attack=ALIE)
    want = norm_agg.rfa_iter_plain(x, wr, w, mask, mean, std, attack=ALIE)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isinf(a), torch.isinf(b))
    fin = torch.isfinite(want[0])
    _near(got[0][fin], want[0][fin], float(want[0][fin].abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("n, s", [(8, 2), (64, 2)])
def test_rfa_iter_on_two_streams(dev, n, s):
    """Launches in flight on two streams at once keep their own tickets, so
    each call of a grid of many blocks equals the one-stream call bit for
    bit, and so does a later call on the first stream."""
    x, w, mask, mean, std = _inputs(n, 1 << 21, dev, s)
    wr = torch.full((w.shape[0],), 1.0 / w.shape[0], device=dev)
    want = norm_agg.rfa_iter(x, wr, w, mask, mean, std, attack=ALIE)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    got = []
    for _ in range(6):
        for st in streams:
            with torch.cuda.stream(st):
                got.append(norm_agg.rfa_iter(x, wr, w, mask, mean, std,
                                             attack=ALIE))
    torch.cuda.synchronize()
    for g in got + [norm_agg.rfa_iter(x, wr, w, mask, mean, std,
                                      attack=ALIE)]:
        assert all(torch.equal(a, b) for a, b in zip(g, want))


# the blocked weighted sum's shapes: one column a lane (d not a multiple
# of 4: 65 x 1, 128 x 123, 1024 x 4097) or four (130 x 2100, 4096 x 256,
# 128 x 2^20); fewer worker tiles than warps (65 x 1 to 130 x 2100), many
# batches of tiles (4096 x 256: 64 tiles), and more column groups than
# blocks (128 x 2^20)
WSUM_SHAPES = [(65, 1), (128, 123), (130, 2100), (4096, 256), (1024, 4097),
               (128, 1 << 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("m, d", WSUM_SHAPES)
def test_weighted_sum_blocked_one_launch(dev, m, d):
    """One launch a call, equal to the plain version (``torch.equal``: each
    column in the reference's order) and repeated bit for bit."""
    x, _, w = _blocked_inputs(m, d, dev)
    before = norm_agg.weighted_sum_blocked.launches
    got = norm_agg.weighted_sum_blocked(x, w)
    again = norm_agg.weighted_sum_blocked(x, w)
    torch.cuda.synchronize()
    assert norm_agg.weighted_sum_blocked.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, norm_agg.weighted_sum_blocked_plain(x, w))


# the blocked Gram's and distances' shapes: one chunk and several (the
# finish), a partial tile of rows (65, 130, 300) and of columns, d not a
# multiple of 4 (no tensor map: 65 x 1, 128 x 123, 1024 x 4097) or of 8, and
# a diagonal tile alone (m <= 128) or among off-diagonal ones
NORM_BLOCKED_SHAPES = [(65, 1), (128, 123), (130, 2100), (4096, 256),
                       (1024, 4097), (128, 1 << 20), (300, 70000)]


@pytest.mark.gpu
@pytest.mark.parametrize("m, d", NORM_BLOCKED_SHAPES)
def test_pair_gram_blocked_one_launch(dev, m, d):
    """One launch a call (the product on the tensor cores in split
    float32, the chunks' finish in the same launch), repeated bit for bit,
    symmetric bit for bit, within TOL of the largest entry of the plain
    version."""
    x, _, _ = _blocked_inputs(m, d, dev)
    before = norm_agg.pair_gram_blocked.launches
    got = norm_agg.pair_gram_blocked(x)
    again = norm_agg.pair_gram_blocked(x)
    want = norm_agg.pair_gram_blocked_plain(x)
    torch.cuda.synchronize()
    assert norm_agg.pair_gram_blocked.launches == before + 2
    assert torch.equal(got, again) and torch.equal(got, got.T)
    _near(got, want, float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("m, d", NORM_BLOCKED_SHAPES)
def test_sqdist_to_blocked_one_launch(dev, m, d):
    """One launch a call (one chunk writes at once; more chunks finish in
    the same launch), repeated bit for bit, within TOL of the largest
    distance of the plain version."""
    x, z, _ = _blocked_inputs(m, d, dev)
    before = norm_agg.sqdist_to_blocked.launches
    got = norm_agg.sqdist_to_blocked(x, z)
    again = norm_agg.sqdist_to_blocked(x, z)
    want = norm_agg.sqdist_to_blocked_plain(x, z)
    torch.cuda.synchronize()
    assert norm_agg.sqdist_to_blocked.launches == before + 2
    assert torch.equal(got, again)
    _near(got, want, float(want.max()))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pair_gram_blocked", "sqdist_to_blocked"])
def test_blocked_finish_on_two_streams(dev, name):
    """Launches split into chunks, in flight on two streams at once, keep
    their own tickets (a buffer for each stream): each result equals the
    one-stream call bit for bit, and so does a later call."""
    m, d = 300, 70000
    x, z, _ = _blocked_inputs(m, d, dev)
    args = (x,) if name == "pair_gram_blocked" else (x, z)
    assert (norm_agg.gram_plan(m, d)[0] if name == "pair_gram_blocked"
            else norm_agg.sqdist_plan(m, d)[0]) > 16   # two-level finish
    fn = BLOCKED[name]
    want = fn(*args)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    got = []
    for _ in range(6):
        for st in streams:
            with torch.cuda.stream(st):
                got.append(fn(*args))
    torch.cuda.synchronize()
    for g in got + [fn(*args)]:
        assert torch.equal(g, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 32])
def test_tf32_wgmma_tile(dev, k):
    """The Gram kernel's tensor-core product alone (wgmma m64n128k8 on
    TF32 operands from 128-byte-swizzled shared memory, k / 8 steps along
    the swizzled row): on values that TF32 holds exactly, a bᵀ within
    float32 accumulation of the float64 product, so a wrong descriptor,
    swizzle or fragment layout shows."""
    g = torch.Generator(device=dev).manual_seed(k)
    a, b = (torch.randn(r, k, device=dev, generator=g) for r in (64, 128))
    a, b = (t.view(torch.int32).bitwise_and(-8192).view(torch.float32)
            for t in (a, b))                 # 10 mantissa bits: exact TF32
    got = norm_agg.tf32_tile(a, b)
    want = (a.double() @ b.double().T).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * k)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["randk", "topk"])
@pytest.mark.parametrize("d, k, blocks", [(1, 1, 1), (123, 12, 1),
                                          (5000, 500, 3), (5000, 4999, 7),
                                          (70000, 7000, 50),
                                          (1 << 22, 419_430, 264)])
def test_sparse_range_search(dev, kind, d, k, blocks):
    """The looping kernels' warp search on the card equals its plain twin
    (and torch.searchsorted), blocks starting mid-run of a row's entries
    included."""
    n = 8
    if kind == "randk":
        keys = R.fold_in(R.PRNGKey(d, device=dev), torch.arange(n,
                                                               device=dev))
        idx = torch.sort(R.permutation(keys, d)[:, :k], dim=1).values.int()
    else:
        g = torch.Generator(device=dev).manual_seed(d)
        x = torch.randn(n, d, device=dev, generator=g)
        idx = torch.sort(topk_select(x, k), dim=1).values.int()
    got = quantize.sparse_bounds(idx, d, 512, blocks)
    want = quantize.sparse_bounds_plain(idx.cpu(), d, 512, blocks)
    assert torch.equal(got.cpu(), want)
