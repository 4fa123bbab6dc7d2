"""qwen3-1.7b [dense] — qk_norm, GQA.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936 [hf:Qwen/Qwen3-8B]
"""
from repro_torch.configs.base import ArchConfig, ATTN, register

CONFIG = register(ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    citation="hf:Qwen/Qwen3-8B",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151_936,
    head_dim=128,
    block_pattern=(ATTN,),
    qk_norm=True,
    rope_theta=1_000_000.0,
))
