"""The numerical design of ``pair_gram_blocked``'s kernel on the tensor
cores, emulated in numpy, against the plain version the CPU path takes.

The kernel (``csrc/norm_agg_blocked.cu``) splits each float32 value as
x = hi + lo, hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
with ties away from zero (``cvt.rna.tf32.f32``), and takes x·y as hi·hi +
hi·lo + lo·hi on TF32 operands. Here each run of columns takes its three
products in float64, rounded to float32 once, and the runs are folded in
float32 in order. Over the reference's column tile (``_tile_for(d)``
columns) the emulated Gram stays within a tenth of ``chip_smoke.py``'s
SUM_TOL (1e-5 of the largest entry) of ``pair_gram_blocked_plain``, where
one TF32 product (hi·hi alone) does not. The tensor cores' own float32
accumulation truncates (not modelled here): over 2048 columns it left the
diagonal 2e-5 low on an H100, so the kernel restarts its running sums
every 128 columns; the longer float32 chain of folds that this takes
stays within a quarter of SUM_TOL, the rest of the tolerance left to the
truncation inside each 128-column run (about 1e-6 measured). The kernel
itself is held to the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import norm_agg

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)

SUM_TOL = 1e-5


def tf32_rna(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32``: half of the dropped 13 bits added
    to the magnitude, then the 13 bits cleared."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def emulated_gram(x, products=3, run=None):
    """The split Gram: per run of columns (default the reference's column
    tile), hi·hi + hi·lo + lo·hi (or hi·hi alone for ``products=1``) in
    float64, rounded to float32, folded in float32 in order. The runs are
    one batch of float64 products (the last run padded with zero columns,
    which add exact zeros), so the test makes a few BLAS calls where a
    loop over the runs made thousands."""
    m, d = x.shape
    tile = run or norm_agg._tile_for(d)
    runs = -(-d // tile)
    xp = np.zeros((m, runs * tile), dtype=np.float32)
    xp[:, :d] = x
    hi, lo = (torch.from_numpy(t.astype(np.float64))
              .reshape(m, runs, tile).transpose(0, 1) for t in split(xp))
    t = hi @ hi.mT
    if products == 3:
        t = hi @ lo.mT + lo @ hi.mT + t
    return np.add.accumulate(t.numpy().astype(np.float32), axis=0)[-1]


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                   # TF32's ulp at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 * 0.99,
                  one + ulp * 1.5, 0.0], dtype=np.float32)
    assert tf32_rna(x).tolist() == [one + ulp, -(one + ulp), one,
                                    one + 2 * ulp, 0.0]
    v = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi, lo = split(v)
    assert np.all(np.abs(v - (hi + lo)) <= np.abs(v) * 2.0 ** -21)
    assert np.all((hi.view(np.uint32) & 0x1FFF) == 0)
    assert np.all((lo.view(np.uint32) & 0x1FFF) == 0)


@pytest.mark.parametrize("d", [123, 4097, 65536])
@pytest.mark.parametrize("m", [65, 130])
def test_split_tf32_gram_within_tolerance(m, d):
    x = np.random.default_rng(m * 7919 + d).standard_normal(
        (m, d)).astype(np.float32)
    want = norm_agg.pair_gram_blocked_plain(torch.from_numpy(x)).numpy()
    limit = SUM_TOL / 10 * float(np.abs(want).max())
    assert float(np.abs(emulated_gram(x) - want).max()) <= limit
    assert float(np.abs(emulated_gram(x, products=1) - want).max()) > limit


@pytest.mark.parametrize("d", [123, 4097, 65536])
@pytest.mark.parametrize("m", [65, 130])
def test_kernel_folds_every_128_columns_within_tolerance(m, d):
    x = np.random.default_rng(m * 7919 + d).standard_normal(
        (m, d)).astype(np.float32)
    want = norm_agg.pair_gram_blocked_plain(torch.from_numpy(x)).numpy()
    limit = SUM_TOL / 4 * float(np.abs(want).max())
    assert float(np.abs(emulated_gram(x, run=128) - want).max()) <= limit
