"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2 routing.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064
[hf:microsoft/Phi-3.5-MoE-instruct]
"""
from repro_torch.configs.base import ArchConfig, ATTN, MoEConfig, register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    block_pattern=(ATTN,),
    moe=MoEConfig(num_experts=16, top_k=2, num_shared=0, d_expert=6400),
))
