"""gemma3-4b — dense transformer, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]  34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144.  Every 6th layer is global attention; the other five
use a 1024-token sliding window.  GeGLU FFN, qk-norm.
"""

from .base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family=DENSE,
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    activation="gelu",
    qk_norm=True,
    rope="rope",
    rope_theta=1e6,
    sliding_window=1024,
    global_attn_every=6,
    tie_embeddings=True,
)
