"""starcoder2-3b [dense] — GQA, RoPE.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 [arXiv:2402.19173]
"""
from repro_torch.configs.base import ArchConfig, ATTN, register

CONFIG = register(ArchConfig(
    name="starcoder2-3b",
    family="dense",
    citation="arXiv:2402.19173",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49_152,
    block_pattern=(ATTN,),
    rope_theta=100_000.0,
))
