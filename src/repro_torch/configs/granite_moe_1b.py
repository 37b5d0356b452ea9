"""granite-moe-1b-a400m — MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  24L d_model=1024 16H
(GQA kv=8) d_ff=512 (per expert) vocab=49155, MoE 32e top-8.
"""

from .base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family=MOE,
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=32,
    top_k=8,
    rope="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
