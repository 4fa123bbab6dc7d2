"""The looping kernels' sparse range search, in its plain twin
(``quantize.sparse_range_start``, step for step the warp's 32-ary search of
``csrc/agg_prologue.cuh``), against ``torch.searchsorted`` and the row
pointers ``wire_starts`` builds; and the masks handed to the kernels
without a conversion. The kernel itself is held to the twin on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import pytest
import torch

from repro_torch import random as R
from repro_torch.kernels import _launch, quantize
from repro_torch.kernels.quantize import (sparse_bounds, sparse_bounds_plain,
                                          sparse_range_start, wire_starts)

# the test workers share the host's cores: each takes a small intra-op
# pool, not one thread a core (oversubscribed pools spin on barriers)
torch.set_num_threads(2)


def _rows(kind, n, d, seed=0):
    """(n, k) ascending int32 idx rows: RandK 0.1 or TopK 0.1 of random
    rows (TopK's indices cluster where |x| is large)."""
    k = max(int(0.1 * d), 1)
    if kind == "randk":
        keys = R.fold_in(R.PRNGKey(d + seed), torch.arange(n))
        return torch.sort(R.permutation(keys, d)[:, :k], dim=1).values.int()
    g = torch.Generator().manual_seed(d + seed)
    x = torch.randn(n, d, generator=g) * torch.linspace(0.1, 3.0, d)
    return torch.sort(quantize.topk_select(x, k), dim=1).values.int()


@pytest.mark.parametrize("kind", ["randk", "topk"])
@pytest.mark.parametrize("d", [1, 123, 5000])
def test_range_start_is_searchsorted(kind, d):
    """Every target from before the first column to past the last, so
    ranges start before, on and inside a row's runs of entries."""
    idx = _rows(kind, 4, d)
    targets = torch.arange(-2, d + 3, dtype=torch.int32)
    want = torch.searchsorted(idx, targets.expand(4, -1).contiguous(),
                              out_int32=True)
    for i, row in enumerate(idx.tolist()):
        got = [sparse_range_start(row, int(t)) for t in targets]
        assert got == want[i].tolist()


@pytest.mark.parametrize("kind", ["randk", "topk"])
@pytest.mark.parametrize("d, group", [(1, 512), (123, 128), (123, 512),
                                      (5000, 128), (5000, 512),
                                      (5000, 2048)])
def test_block_bounds_match_the_row_pointers(kind, d, group):
    """Where each block of a looping grid starts in each row is the row
    pointer of its first group, for any number of blocks (a block's first
    group starts mid-run of a row's entries when blocks do not divide the
    groups)."""
    idx = _rows(kind, 5, d, seed=1)
    groups = -(-d // group)
    starts = wire_starts(idx, d, group)
    for blocks in sorted({1, 2, 3, 7, groups, groups + 5}):
        got = sparse_bounds_plain(idx, d, group, blocks)
        assert got.shape == (blocks, 5)
        first = torch.tensor([groups * b // blocks for b in range(blocks)])
        assert torch.equal(got, starts[:, first].T)
        assert torch.equal(sparse_bounds(idx, d, group, blocks), got)


def test_search_of_a_long_row_takes_few_steps():
    """k = 419,430 (RandK 0.1 of one qwen3-1.7b q_proj layer): the 32-ary
    search narrows 33-fold a step: four dependent loads, three steps of
    32 probes and the last ≤ 32 positions."""
    d = 1 << 22
    idx = _rows("randk", 1, d)[0]
    row = idx.tolist()
    for t in (0, 1, 12345, d // 3, d - 1, d):
        want = int(torch.searchsorted(idx, torch.tensor([t],
                                                        dtype=torch.int32)))
        assert sparse_range_start(row, t) == want
    span, steps = len(row), 0
    while span > 32:
        span, steps = span // 33 + 1, steps + 1
    assert steps + 1 == 4


def test_masks_go_to_the_kernels_unconverted():
    """A bool mask is a zero-copy uint8 view (no conversion is launched);
    a float32 mask is passed as it is (> 0 set)."""
    m = torch.tensor([True, False, True])
    ptr, is_u8 = _launch.mask_arg("t", "mask", m, m.device, (3,))
    assert is_u8 and ptr == m.data_ptr()
    f = torch.tensor([1.0, 0.0, 0.5])
    ptr, is_u8 = _launch.mask_arg("t", "mask", f, f.device, (3,))
    assert not is_u8 and ptr == f.data_ptr()
    with pytest.raises(TypeError):
        _launch.mask_arg("t", "mask", f.double(), f.device, (3,))
