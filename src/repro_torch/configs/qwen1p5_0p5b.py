"""qwen1.5-0.5b — dense transformer with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]  24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936.
"""

from .base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family=DENSE,
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    rope="rope",
    rope_theta=1e6,
    tie_embeddings=True,
)
