"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern.

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000 [arXiv:2402.19427]
Griffin block pattern: two recurrent (RG-LRU) blocks then one local-attention
block, repeated. Local attention window 2048 per the paper.
"""
from repro_torch.configs.base import ArchConfig, RGLRU, SWA, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    citation="arXiv:2402.19427",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    block_pattern=(RGLRU, RGLRU, SWA),
    sliding_window=2048,
    rglru_width=2560,
    conv_width=4,
    supports_long_context=True,
))
