"""qwen2-vl-2b — VLM transformer backbone with M-RoPE.

[arXiv:2409.12191; hf]  28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936.  The vision frontend is a stub: the model takes precomputed
patch embeddings (``embeds``); M-RoPE splits the head dim into (temporal,
height, width) rotary sections.
"""

from .base import VLM, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family=VLM,
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope="mrope",
    rope_theta=1e6,
    frontend="patch",
    tie_embeddings=True,
)
