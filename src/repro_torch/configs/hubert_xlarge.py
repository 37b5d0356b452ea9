"""hubert-xlarge — encoder-only audio transformer (wav2vec2-style backbone).

[arXiv:2106.07447; unverified]  48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (target codebook).  The conv feature extractor is a stub: the
model takes precomputed frame embeddings (``embeds``) and adds the learned
position table to them (the published model's convolutional position
embedding is not modelled).  Bidirectional (non-causal) attention; no
decode shapes.
"""

from .base import AUDIO, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family=AUDIO,
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    activation="gelu",
    gated_ffn=False,
    norm="layernorm",
    rope="none",
    encoder_only=True,
    causal=False,
    frontend="frame",
    tie_embeddings=False,
)
