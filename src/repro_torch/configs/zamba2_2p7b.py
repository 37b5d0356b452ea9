"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]  54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64.  A single *shared-parameter* attention+MLP block
is applied every 6 Mamba2 layers (Zamba-style parameter sharing).
"""

from .base import HYBRID, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family=HYBRID,
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    activation="gelu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    shared_attn_every=6,
    rope="rope",
    tie_embeddings=True,
)
