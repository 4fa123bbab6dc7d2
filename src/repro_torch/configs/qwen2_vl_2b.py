"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 [arXiv:2409.12191]
Vision encoder (ViT) is a STUB per the task carve-out: ``input_specs`` supplies
precomputed patch embeddings of shape (batch, frontend_tokens, d_model); this
config is the language decoder that consumes them interleaved with text tokens.
"""
from repro_torch.configs.base import ArchConfig, ATTN, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    citation="arXiv:2409.12191",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    block_pattern=(ATTN,),
    mrope_sections=(16, 24, 24),   # t/h/w split of head_dim=128 rotary pairs /2
    frontend_tokens=256,           # stubbed ViT patch embeddings per example
    rope_theta=1_000_000.0,
))
