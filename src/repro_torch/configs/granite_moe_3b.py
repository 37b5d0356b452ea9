"""granite-moe-3b-a800m — MoE, 40 experts top-8.

[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]  32L d_model=1536 24H
(GQA kv=8) d_ff=512 (per expert) vocab=49155, MoE 40e top-8.
"""

from .base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family=MOE,
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    top_k=8,
    rope="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
