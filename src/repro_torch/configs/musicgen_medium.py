"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284]
The EnCodec conv codec is a STUB per the task carve-out: ``input_specs``
supplies precomputed frame embeddings / codebook token ids. We model the 4
parallel RVQ codebooks as 4 summed embedding tables + 4 output heads
(the paper's delay interleave pattern is a data-layout detail, omitted).
"""
from repro_torch.configs.base import ArchConfig, ATTN, register

CONFIG = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    citation="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    block_pattern=(ATTN,),
    num_codebooks=4,
    frontend_tokens=64,     # stubbed conditioning (text/melody) embeddings
))
