"""qwen3-0.6b — dense transformer with qk-norm and GQA.

[hf:Qwen/Qwen3-8B; hf]  28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936.
"""

from .base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family=DENSE,
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope="rope",
    rope_theta=1e6,
    tie_embeddings=True,
)
