"""llama3-8b — dense transformer, GQA, 128k vocab.

[arXiv:2407.21783; unverified]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.
"""

from .base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family=DENSE,
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope="rope",
    rope_theta=500_000.0,
    tie_embeddings=False,
)
