"""GPT-2 (medium) — the paper's primary evaluation model, and the paper's
three companion models (Table 7).

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

# Paper Table 7 companions (Fig. 9 / Fig. 10 studies).
PAPER_QWEN = ModelConfig(
    name="paper-qwen2.5-0.5b", family=DENSE, num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, d_ff=4864, vocab_size=151936,
    qkv_bias=True, rope="rope", tie_embeddings=True)

PAPER_LLAMA = ModelConfig(
    name="paper-llama3.2-1b", family=DENSE, num_layers=22, d_model=2048,
    num_heads=32, num_kv_heads=4, d_ff=5632, vocab_size=128256,
    rope="rope", rope_theta=500_000.0, tie_embeddings=True)

PAPER_GEMMA = ModelConfig(
    name="paper-gemma-2b", family=DENSE, num_layers=26, d_model=1152,
    num_heads=4, num_kv_heads=1, d_ff=6912, vocab_size=262144,
    activation="gelu", rope="rope", tie_embeddings=True)
