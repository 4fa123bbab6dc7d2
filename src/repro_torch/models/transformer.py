"""The decoder stack (port of ``repro/models/transformer.py``).

Layers are stacked per pattern position, as in the reference: the flat
parameter dict holds ``groups/{j}/<block path>`` leaves with a leading
repeat axis of ``num_layers // len(block_pattern)`` rows, and
``tail/{i}/<block path>`` for the leftover layers. So the leaves the
aggregation kernels see (28 × 2048 × 2048 for qwen3-1.7b's ``wq``) are
the reference's, and the sorted keys walk the tree in
``jax.tree.flatten``'s order.

Every block kind of the reference is built: the attention blocks
(``ATTN``, ``SWA``, ``MLA``) and the RG-LRU block with a dense gated MLP
or the MoE FFN, whose load-balance loss the stack carries in float32
through the layers, as the reference's scan does, and the Mamba2 SSD
block, which has no second norm and no FFN.

Decoding keeps the reference's cache tree as a flat dict beside the
parameters: ``groups/{j}/<leaf>`` with a leading ``n_groups`` axis
(``len`` too, one count a group), ``tail/{i}/<leaf>`` for the tail. A
step runs the groups in depth order, as ``apply_stack`` does, and
returns a new cache.
"""
from __future__ import annotations

import math

import torch

from repro_torch import random as R
from repro_torch.configs.base import ATTN, MAMBA2, MLA, RGLRU, SWA
from repro_torch.models import layers as L

_MIXER_INIT = {ATTN: L.init_attention, SWA: L.init_attention,
               MLA: L.init_mla, RGLRU: L.init_rglru, MAMBA2: L.init_mamba2}


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a block kind the reference does not
    know."""
    for kind in dict.fromkeys(cfg.block_pattern):
        if kind not in _MIXER_INIT:
            raise ValueError(kind)


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

def _mixer_shapes(cfg, kind: str) -> dict:
    """The mixer's leaf shapes for every block kind of the reference."""
    if kind in (ATTN, SWA):
        return L.attention_shapes(cfg)
    if kind == MLA:
        return L.mla_shapes(cfg)
    if kind == RGLRU:
        return L.rglru_shapes(cfg)
    if kind == MAMBA2:
        return L.mamba2_shapes(cfg)
    raise ValueError(kind)


def _ffn_shapes(cfg) -> dict:
    return L.mlp_shapes(cfg) if cfg.moe is None else L.moe_shapes(cfg)


def block_shapes(cfg, kind: str) -> dict:
    """{path within the block: shape} of one block of ``kind``."""
    shapes = {"norm1": (cfg.d_model,)}
    shapes.update({f"mixer/{k}": s
                   for k, s in _mixer_shapes(cfg, kind).items()})
    if kind != MAMBA2:
        shapes["norm2"] = (cfg.d_model,)
        shapes.update({f"ffn/{k}": s for k, s in _ffn_shapes(cfg).items()})
    return shapes


def _init_block(key, cfg, kind: str) -> dict:
    """The mixer from the first of three keys, the FFN (none in a Mamba2
    block) from the second."""
    check_supported(cfg)
    k1, k2, _ = R.split(key, 3)
    d = cfg.d_model
    p = {"norm1": torch.zeros((d,), dtype=cfg.torch_dtype, device=key.device)}
    p.update({f"mixer/{k}": v for k, v in _MIXER_INIT[kind](k1, cfg).items()})
    if kind == MAMBA2:
        return p
    p["norm2"] = torch.zeros((d,), dtype=cfg.torch_dtype, device=key.device)
    ffn = L.init_mlp(k2, cfg) if cfg.moe is None else L.init_moe(k2, cfg)
    p.update({f"ffn/{k}": v for k, v in ffn.items()})
    return p


def _apply_block(params: dict, cfg, kind: str, x, positions, aux):
    """One block -> (x, aux), the MoE FFN's load-balance loss added to
    ``aux``."""
    h = L.rms_norm(x, params["norm1"], cfg.norm_eps)
    mixer = L.subtree(params, "mixer/")
    if kind == MLA:
        x = x + L.mla_attention(mixer, cfg, h, positions)
    elif kind == RGLRU:
        x = x + L.rglru_block(mixer, cfg, h)
    elif kind == MAMBA2:
        return x + L.mamba2_block(mixer, cfg, h), aux
    else:
        window = cfg.sliding_window if kind == SWA else None
        x = x + L.attention(mixer, cfg, h, positions, window=window)
    h = L.rms_norm(x, params["norm2"], cfg.norm_eps)
    if cfg.moe is None:
        return x + L.mlp(L.subtree(params, "ffn/"), h), aux
    y, a = L.moe_ffn(L.subtree(params, "ffn/"), cfg, h)
    return x + y, aux + a


def _decode_block(params: dict, cfg, kind: str, x, cache: dict):
    """One block's one-token step -> (x, new cache); the MoE FFN's
    load-balance loss is dropped, as the reference drops it."""
    h = L.rms_norm(x, params["norm1"], cfg.norm_eps)
    mixer = L.subtree(params, "mixer/")
    if kind == ATTN:
        mixed, cache = L.attention_decode(mixer, cfg, h, cache)
    elif kind == SWA:
        mixed, cache = L.attention_decode(mixer, cfg, h, cache,
                                          window=cfg.sliding_window)
    elif kind == MLA:
        mixed, cache = L.mla_decode(mixer, cfg, h, cache)
    elif kind == RGLRU:
        mixed, cache = L.rglru_decode(mixer, cfg, h, cache)
    elif kind == MAMBA2:
        mixed, cache = L.mamba2_decode(mixer, cfg, h, cache)
        return x + mixed, cache
    else:
        raise ValueError(kind)
    x = x + mixed
    h = L.rms_norm(x, params["norm2"], cfg.norm_eps)
    if cfg.moe is None:
        return x + L.mlp(L.subtree(params, "ffn/"), h), cache
    y, _ = L.moe_ffn(L.subtree(params, "ffn/"), cfg, h)
    return x + y, cache


def _init_block_cache(cfg, kind: str, batch, capacity, device=None) -> dict:
    if kind == ATTN:
        return L.init_attention_cache(cfg, batch, capacity, device=device)
    if kind == SWA:
        return L.init_attention_cache(cfg, batch, capacity,
                                      window=cfg.sliding_window,
                                      device=device)
    if kind == MLA:
        return L.init_mla_cache(cfg, batch, capacity, device)
    if kind == RGLRU:
        return L.init_rglru_cache(cfg, batch, device=device)
    if kind == MAMBA2:
        return L.init_mamba2_cache(cfg, batch, device=device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def _split_depth(cfg):
    pat = tuple(cfg.block_pattern)
    n_groups = cfg.num_layers // len(pat)
    tail = tuple(cfg.blocks()[n_groups * len(pat):])
    return pat, n_groups, tail


def stack_shapes(cfg) -> dict:
    """{flat key: shape} of the stack's leaves, for every config."""
    pat, n_groups, tail = _split_depth(cfg)
    out = {}
    for j, kind in enumerate(pat):
        for k, s in block_shapes(cfg, kind).items():
            out[f"groups/{j}/{k}"] = (max(n_groups, 1),) + s
    for i, kind in enumerate(tail):
        for k, s in block_shapes(cfg, kind).items():
            out[f"tail/{i}/{k}"] = s
    return out


def init_stack(key, cfg) -> dict:
    """Each pattern position's blocks drawn from split keys, one per
    repeat, and stacked: the numbers of the reference's vmapped init. A
    stack whose largest leaf would pass 2³¹ − 8 entries (llama3-405b) is
    one block broadcast over the repeats, as the reference does."""
    pat, n_groups, tail = _split_depth(cfg)
    keys = R.split(key, len(pat) + len(tail))
    out = {}
    for j, kind in enumerate(pat):
        biggest = max(math.prod(s) for s in block_shapes(cfg, kind).values())
        if n_groups * biggest > 2 ** 31 - 8:
            one = _init_block(keys[j], cfg, kind)
            stacked = {k: v[None].expand((n_groups,) + tuple(v.shape))
                       for k, v in one.items()}
        else:
            sub = R.split(keys[j], max(n_groups, 1))
            blocks = [_init_block(sub[r], cfg, kind)
                      for r in range(sub.shape[0])]
            stacked = {k: torch.stack([b.pop(k) for b in blocks])
                       for k in sorted(blocks[0])}
        out.update({f"groups/{j}/{k}": v for k, v in stacked.items()})
    for i, kind in enumerate(tail):
        one = _init_block(keys[len(pat) + i], cfg, kind)
        out.update({f"tail/{i}/{k}": v for k, v in one.items()})
    return out


def _group_rows(tree: dict, j: int) -> dict:
    """Pattern position ``j``'s stacked leaves, each unbound into its
    ``n_groups`` rows."""
    return {k: v.unbind(0)
            for k, v in L.subtree(tree, f"groups/{j}/").items()}


def apply_stack(params: dict, cfg, x, positions, *, remat: bool = False):
    """Every group's blocks in depth order, then the tail -> (x, aux),
    aux the float32 sum of the MoE layers' load-balance losses in layer
    order (a zero without MoE). Each stacked leaf is unbound once, so its
    gradient is one stack of the layers' gradients."""
    if remat:
        raise NotImplementedError(
            "remat=True: torch.utils.checkpoint does not run under "
            "torch.func's grad and vmap (they refuse saved-tensor hooks), "
            "and the round engine differentiates through them")
    pat, n_groups, tail = _split_depth(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if n_groups > 0:
        per_pos = [_group_rows(params, j) for j in range(len(pat))]
        for r in range(n_groups):
            for j, kind in enumerate(pat):
                block = {k: v[r] for k, v in per_pos[j].items()}
                x, aux = _apply_block(block, cfg, kind, x, positions, aux)
    for i, kind in enumerate(tail):
        x, aux = _apply_block(L.subtree(params, f"tail/{i}/"), cfg, kind, x,
                              positions, aux)
    return x, aux


def init_stack_cache(cfg, batch, capacity, device=None) -> dict:
    """Empty caches: each pattern position's broadcast over the
    ``n_groups`` repeats, then the tail's."""
    pat, n_groups, tail = _split_depth(cfg)
    out = {}
    for j, kind in enumerate(pat):
        one = _init_block_cache(cfg, kind, batch, capacity, device)
        out.update({f"groups/{j}/{k}": v[None].expand(
            (n_groups,) + tuple(v.shape)).clone() for k, v in one.items()})
    for i, kind in enumerate(tail):
        one = _init_block_cache(cfg, kind, batch, capacity, device)
        out.update({f"tail/{i}/{k}": v for k, v in one.items()})
    return out


def decode_stack(params: dict, cfg, x, cache: dict):
    """One token through every group's blocks in depth order, then the
    tail -> (x, new cache); each group's new cache rows are stacked back
    into the ``n_groups`` axis."""
    pat, n_groups, tail = _split_depth(cfg)
    new = {}
    if n_groups > 0:
        p_rows = [_group_rows(params, j) for j in range(len(pat))]
        c_rows = [_group_rows(cache, j) for j in range(len(pat))]
        outs = [[] for _ in pat]
        for r in range(n_groups):
            for j, kind in enumerate(pat):
                x, c = _decode_block({k: v[r] for k, v in p_rows[j].items()},
                                     cfg, kind, x,
                                     {k: v[r] for k, v in c_rows[j].items()})
                outs[j].append(c)
        for j, rows in enumerate(outs):
            new.update({f"groups/{j}/{k}": torch.stack([c[k] for c in rows])
                        for k in rows[0]})
    for i, kind in enumerate(tail):
        x, c = _decode_block(L.subtree(params, f"tail/{i}/"), cfg, kind, x,
                             L.subtree(cache, f"tail/{i}/"))
        new.update({f"tail/{i}/{k}": v for k, v in c.items()})
    return x, new
