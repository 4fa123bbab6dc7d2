"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060]
"""
from repro_torch.configs.base import ArchConfig, MAMBA2, register

CONFIG = register(ArchConfig(
    name="mamba2-130m",
    family="ssm",
    citation="arXiv:2405.21060",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    block_pattern=(MAMBA2,),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    conv_width=4,
    tie_embeddings=True,
    supports_long_context=True,
))
