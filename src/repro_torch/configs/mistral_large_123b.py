"""mistral-large-123b [dense].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768
[hf:mistralai/Mistral-Large-Instruct-2407]
"""
from repro_torch.configs.base import ArchConfig, ATTN, register

CONFIG = register(ArchConfig(
    name="mistral-large-123b",
    family="dense",
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32_768,
    head_dim=128,
    block_pattern=(ATTN,),
    rope_theta=1_000_000.0,
))
