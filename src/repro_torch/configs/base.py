"""Architecture and input-shape configs (port of
``repro/configs/base.py``).

Every assigned architecture registers an ``ArchConfig`` through its own
module in ``repro_torch.configs``; the fields, ``reduced()`` and the
parameter counts are the reference's. All ten configs register: they are
data. ``models.init_params`` refuses the block kinds the port does not
build yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# ---------------------------------------------------------------------------
# Block kinds that models/transformer.py knows how to build.
# ---------------------------------------------------------------------------
ATTN = "attention"            # full-causal GQA attention
SWA = "sliding_window"        # sliding-window (local) causal attention
MLA = "mla"                   # DeepSeek multi-head latent attention
RGLRU = "rg_lru"              # RecurrentGemma gated linear recurrence block
MAMBA2 = "mamba2"             # Mamba2 SSD block (attention-free)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_expert: Optional[int] = None      # expert hidden dim (defaults to d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                          # dense | moe | ssm | hybrid | vlm | audio
    citation: str
    num_layers: int
    d_model: int
    num_heads: int                       # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default d_model // num_heads
    # block pattern repeated over depth; default all-attention
    block_pattern: tuple = (ATTN,)
    moe: Optional[MoEConfig] = None
    # attention extras
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Optional[tuple] = None   # (t, h, w) head_dim split for M-RoPE
    sliding_window: int = 4096               # window used by SWA blocks
    # MLA extras
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    # SSM / RG-LRU extras
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    conv_width: int = 4
    rglru_width: int = 0                 # lru width (defaults d_model)
    # modality frontend stub: number of prepended embedding tokens in input_specs
    frontend_tokens: int = 0
    num_codebooks: int = 1               # musicgen-style parallel codebooks
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # decode support
    supports_long_context: bool = True   # via SWA/recurrent state (see DESIGN.md)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def blocks(self) -> list:
        """Per-layer block kinds, the pattern tiled to num_layers."""
        pat = list(self.block_pattern)
        reps = (self.num_layers + len(pat) - 1) // len(pat)
        return (pat * reps)[: self.num_layers]

    # parameter count (approx, embedding included once) --------------------
    def param_count(self) -> int:
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d * self.num_codebooks          # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d * self.num_codebooks     # unembed
        counts = {}
        for kind in self.blocks():
            counts[kind] = counts.get(kind, 0) + 1
        for kind, n in counts.items():
            if kind in (ATTN, SWA):
                attn = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
                total += n * attn
            elif kind == MLA:
                r = self.kv_lora_rank
                attn = (d * r + r * nq * (hd + hd)               # kv down/up
                        + d * self.qk_rope_dim                    # rope key
                        + d * nq * hd + nq * hd * d)              # q and out
                total += n * attn
            elif kind == RGLRU:
                w = self.rglru_width or self.d_model
                total += n * (2 * d * w + 2 * w + w * d + self.conv_width * w)
            elif kind == MAMBA2:
                di = self.ssm_expand * d
                total += n * (d * (2 * di + 2 * self.ssm_state) + di * d
                              + self.conv_width * di)
            # mlp for every block except pure mamba2 (mamba2 has none)
            if kind != MAMBA2:
                if self.moe is not None:
                    de = self.moe.d_expert or ff
                    n_e = self.moe.num_experts + self.moe.num_shared
                    total += n * (n_e * 3 * d * de + d * self.moe.num_experts)
                else:
                    total += n * 3 * d * ff
        total += L * 2 * d + d                                    # norms
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        de = self.moe.d_expert or ff
        n_e = self.moe.num_experts + self.moe.num_shared
        act = self.moe.top_k + self.moe.num_shared
        dense_like = self.param_count() - self.num_layers * n_e * 3 * d * de
        return int(dense_like + self.num_layers * act * 3 * d * de)

    # reduced variant for CPU smoke tests -----------------------------------
    def reduced(self) -> "ArchConfig":
        kw = dict(
            num_layers=min(self.num_layers, len(self.block_pattern), 3) or 2,
            d_model=min(self.d_model, 128),
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=64,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            qk_rope_dim=16,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32,
            rglru_width=min(self.rglru_width, 128) if self.rglru_width else 0,
            frontend_tokens=min(self.frontend_tokens, 4),
            dtype="float32",
        )
        # keep at least one of each pattern element
        kw["num_layers"] = max(2, len(self.block_pattern))
        nh = max(2, min(self.num_heads, 4))
        nkv = max(1, min(self.num_kv_heads, nh))
        while nh % nkv:
            nkv -= 1
        kw["num_heads"] = nh
        kw["num_kv_heads"] = nkv
        kw["head_dim"] = 32
        if self.mrope_sections is not None:
            kw["mrope_sections"] = (4, 6, 6)   # sums to head_dim//2 = 16
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                num_shared=min(self.moe.num_shared, 1),
                d_expert=64,
                capacity_factor=2.0,
            )
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}
_LOADED = [False]


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import all sibling config modules once
    if _LOADED[0]:
        return
    from repro_torch.configs import (  # noqa: F401
        recurrentgemma_2b, phi35_moe_42b, starcoder2_3b, qwen2_vl_2b,
        qwen3_1p7b, mamba2_130m, mistral_large_123b, deepseek_v2_lite_16b,
        llama3_405b, musicgen_medium,
    )
    _LOADED[0] = True


ASSIGNED_ARCHS = (
    "recurrentgemma-2b", "phi3.5-moe-42b-a6.6b", "starcoder2-3b", "qwen2-vl-2b",
    "qwen3-1.7b", "mamba2-130m", "mistral-large-123b", "deepseek-v2-lite-16b",
    "llama3-405b", "musicgen-medium",
)
