"""Wire formats for the one-sweep compressed pipeline (port of the sparse
parts of ``repro/kernels/quantize.py``).

Sparse payload of one leaf: vals (n, k) float32 and idx (n, k) int32,
ascending per worker row (RandK keeps the d/k scaling in vals). The CUDA
robust-aggregation kernel rebuilds each tile of the candidates from it,
bounded by CSR row pointers (``wire_starts``), so the dense (n, d)
candidate matrix never exists in device memory. ``decode`` is the plain
reconstruction the CPU path and the tests use.

Not ported yet (ROADMAP queue 2): the int8 / sign / bf16 wire loads,
``topk_select`` and ``block_quantize``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as R

WIRE_FORMATS = ("sparse", "int8", "sign", "bf16", "dense32")


@dataclasses.dataclass(frozen=True)
class WireSrc:
    """One worker-stacked wire payload standing in for the dense (n, d)
    candidate matrix at a kernel call site. ``arrays`` is a tuple of
    (name, (n, ...) tensor); ``base`` is the reconstruction base added in
    the kernel: (n, d) per-worker state, (1, d) a shared server estimate
    (MARINA's g^k), or None."""
    fmt: str
    n: int
    d: int
    arrays: tuple
    base: Optional[torch.Tensor] = None
    cand_dtype: torch.dtype = torch.float32

    @property
    def device(self):
        return self.arrays[0][1].device


def pack_sparse(key, x, ratio: float, *, topk: bool):
    """RandK payload of a leaf: {"vals": (..., k), "idx": (..., k) int32
    ascending}. ``key`` (..., 2) and ``x`` (..., d) share leading axes, so
    one call packs every worker; the selection is the permutation
    ``rand_k`` draws, so supports equal the dense compressor's."""
    if topk:
        raise NotImplementedError(
            "TopK wire is not ported yet (ROADMAP queue 1, item 6; "
            "topk_select in queue 2)")
    d = x.shape[-1]
    k = max(int(ratio * d), 1)
    sel = R.permutation(key, d)[..., :k]
    idx = torch.sort(sel, dim=-1).values
    vals = (torch.gather(x, -1, idx) * (d / k)).to(x.dtype)
    return {"vals": vals, "idx": idx.to(torch.int32)}


def decode(fmt: str, payload: dict, d: int):
    """Payload (worker-stacked or one worker) -> dense (..., d) float32."""
    if fmt != "sparse":
        raise NotImplementedError(
            f"wire format {fmt!r} is not ported yet (ROADMAP queue 2)")
    vals = payload["vals"].float()
    out = torch.zeros(vals.shape[:-1] + (d,), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_(-1, payload["idx"].long(), vals)


def recon(src: WireSrc):
    """Plain reconstruction of a WireSrc: decode, round-trip through the
    candidate dtype, add the base, round-trip again -> (n, d) float32."""
    q = decode(src.fmt, dict(src.arrays), src.d)
    q = q.to(src.cand_dtype).float()
    if src.base is None:
        return q
    return (q + src.base.float()).to(src.cand_dtype).float()


def wire_starts(idx, d: int, tile: int):
    """(n, T + 1) int32 CSR row pointers over T = ceil(d / tile) tiles: row
    i's entries for tile t are positions [starts[i, t], starts[i, t + 1])
    of its ascending int32 idx row (a searchsorted per worker)."""
    n_tiles = -(-d // tile)
    bounds = torch.arange(n_tiles + 1, dtype=torch.int32,
                          device=idx.device) * tile
    bounds = bounds.expand(idx.shape[0], n_tiles + 1).contiguous()
    return torch.searchsorted(idx, bounds, out_int32=True)
