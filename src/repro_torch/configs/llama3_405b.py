"""llama3-405b [dense] — GQA, 128k vocab.

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256 [arXiv:2407.21783]
"""
from repro_torch.configs.base import ArchConfig, ATTN, register

CONFIG = register(ArchConfig(
    name="llama3-405b",
    family="dense",
    citation="arXiv:2407.21783",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128_256,
    head_dim=128,
    block_pattern=(ATTN,),
    rope_theta=500_000.0,
))
