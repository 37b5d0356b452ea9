"""rwkv6-7b (Finch) — attention-free RNN with data-dependent decay.

[arXiv:2404.05892; hf]  32L d_model=4096 d_ff=14336 vocab=65536.
Time-mix (wkv6 recurrence, 64 heads of dim 64) + channel-mix blocks;
O(1) state per token at decode.
"""

from .base import SSM, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family=SSM,
    num_layers=32,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    rwkv=True,
    rwkv_head_dim=64,
    rope="none",
    norm="layernorm",
    tie_embeddings=False,
)
