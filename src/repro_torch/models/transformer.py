"""The decoder stack (port of ``repro/models/transformer.py``).

Layers are stacked per pattern position, as in the reference: the flat
parameter dict holds ``groups/{j}/<block path>`` leaves with a leading
repeat axis of ``num_layers // len(block_pattern)`` rows, and
``tail/{i}/<block path>`` for the leftover layers. So the leaves the
aggregation kernels see (28 × 2048 × 2048 for qwen3-1.7b's ``wq``) are
the reference's, and the sorted keys walk the tree in
``jax.tree.flatten``'s order.

This slice builds the attention blocks (``ATTN``, ``SWA``) with dense
gated MLPs. MLA and MoE (ROADMAP queue 1, item 14) and the Mamba2 SSD
and RG-LRU blocks (item 15) raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from repro_torch import random as R
from repro_torch.configs.base import ATTN, MAMBA2, MLA, RGLRU, SWA
from repro_torch.models import layers as L

_ITEM = {MLA: 14, RGLRU: 15, MAMBA2: 15}
_NAMES = {MLA: "MLA attention", RGLRU: "the RG-LRU block",
          MAMBA2: "the Mamba2 SSD block"}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for the block kinds and FFNs this
    slice does not build."""
    for kind in dict.fromkeys(cfg.block_pattern):
        if kind in _ITEM:
            raise NotImplementedError(
                f"{cfg.name}: {_NAMES[kind]} is not ported yet (ROADMAP "
                f"queue 1, item {_ITEM[kind]})")
        if kind not in (ATTN, SWA):
            raise ValueError(kind)
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN is not ported yet (ROADMAP queue 1, "
            "item 14)")


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

def _mixer_shapes(cfg, kind: str) -> dict:
    """The mixer's leaf shapes for every block kind of the reference,
    the kinds this slice does not build included (shapes are data)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq = cfg.num_heads
    if kind in (ATTN, SWA):
        return L.attention_shapes(cfg)
    if kind == MLA:
        r, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
        return {"wq": (d, nq * (hd + rd)), "w_dkv": (d, r),
                "w_uk": (r, nq * hd), "w_uv": (r, nq * hd), "w_kr": (d, rd),
                "wo": (nq * hd, d), "kv_norm": (r,)}
    if kind == RGLRU:
        w = cfg.rglru_width or d
        return {"w_gate_branch": (d, w), "w_rec_branch": (d, w),
                "conv_w": (cfg.conv_width, w), "w_a": (w, w), "b_a": (w,),
                "w_i": (w, w), "b_i": (w,), "lam": (w,), "w_out": (w, d)}
    if kind == MAMBA2:
        di, n = cfg.ssm_expand * d, cfg.ssm_state
        nh = di // cfg.ssm_headdim
        return {"w_in": (d, 2 * di + 2 * n + nh),
                "conv_w": (cfg.conv_width, di + 2 * n), "a_log": (nh,),
                "dt_bias": (nh,), "d_skip": (nh,), "out_norm": (di,),
                "w_out": (di, d)}
    raise ValueError(kind)


def _ffn_shapes(cfg) -> dict:
    if cfg.moe is None:
        return L.mlp_shapes(cfg)
    m, d = cfg.moe, cfg.d_model
    de = m.d_expert or cfg.d_ff
    shapes = {"router": (d, m.num_experts), "w1": (m.num_experts, d, de),
              "w3": (m.num_experts, d, de), "w2": (m.num_experts, de, d)}
    if m.num_shared:
        shapes.update({f"shared/{k}": s for k, s in
                       L.mlp_shapes(cfg, de * m.num_shared).items()})
    return shapes


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
    check_supported(cfg)
    k1, k2, _ = R.split(key, 3)
    d = cfg.d_model
    p = {"norm1": torch.zeros((d,), dtype=cfg.torch_dtype, device=key.device),
         "norm2": torch.zeros((d,), dtype=cfg.torch_dtype, device=key.device)}
    p.update({f"mixer/{k}": v for k, v in L.init_attention(k1, cfg).items()})
    p.update({f"ffn/{k}": v for k, v in L.init_mlp(k2, cfg).items()})
    return p


def _sub(params: dict, prefix: str) -> dict:
    """The leaves under ``prefix`` ("mixer/", "ffn/"), prefix stripped."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def _apply_block(params: dict, cfg, kind: str, x, positions):
    h = L.rms_norm(x, params["norm1"], cfg.norm_eps)
    window = cfg.sliding_window if kind == SWA else None
    x = x + L.attention(_sub(params, "mixer/"), cfg, h, positions,
                        window=window)
    h = L.rms_norm(x, params["norm2"], cfg.norm_eps)
    return x + L.mlp(_sub(params, "ffn/"), h)


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


def apply_stack(params: dict, cfg, x, positions, *, remat: bool = False):
    """Every group's blocks in depth order, then the tail. Each stacked
    leaf is unbound once, so its gradient is one stack of the layers'
    gradients."""
    if remat:
        raise NotImplementedError(
            "remat=True: torch.utils.checkpoint does not run under "
            "torch.func's grad and vmap (they refuse saved-tensor hooks), "
            "and the round engine differentiates through them")
    pat, n_groups, tail = _split_depth(cfg)
    if n_groups > 0:
        per_pos = []
        for j in range(len(pat)):
            sub = _sub(params, f"groups/{j}/")
            rows = {k: v.unbind(0) for k, v in sub.items()}
            per_pos.append(rows)
        for r in range(n_groups):
            for j, kind in enumerate(pat):
                block = {k: v[r] for k, v in per_pos[j].items()}
                x = _apply_block(block, cfg, kind, x, positions)
    for i, kind in enumerate(tail):
        x = _apply_block(_sub(params, f"tail/{i}/"), cfg, kind, x, positions)
    return x
