"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, shared + routed experts top-6.

27L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400, MoE 64e top-6
[arXiv:2405.04434]

NOTE: the assignment line lists both "MoE 64e top-6" and "2 shared+160 routed";
these conflict (the HF card has 64 routed + 2 shared, top-6). We follow
64 routed + 2 shared, top-6, and record the discrepancy in DESIGN.md.
"""
from repro_torch.configs.base import ArchConfig, MLA, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    citation="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    head_dim=128,
    block_pattern=(MLA,),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
    kv_lora_rank=512,
    qk_rope_dim=64,
))
