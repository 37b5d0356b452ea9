"""GPT-2 (medium) — the paper's primary evaluation model.

Paper Table 7: 24L hidden=1024 16H d_ff=4096 vocab=50257, GELU MLP,
LayerNorm, learned positions (modeled as rope="none").
"""

from .base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="gpt2",
    family=DENSE,
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=50257,
    activation="gelu",
    gated_ffn=False,
    norm="layernorm",
    rope="none",
    tie_embeddings=True,
)
