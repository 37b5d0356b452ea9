"""Executable PyTorch model of the port (serving entry points)."""

from .model import (decode_step, prefill, prefill_chunk, resolve_plan,
                    supports_chunked_prefill, supports_speculative,
                    verify_step)
from .params import (KV_CACHE_LEAVES, cache_leaf_kind, compute_dtype,
                     init_params, kv_seq_axis, model_defs, padded_vocab,
                     params_from_numpy)

__all__ = [
    "decode_step", "prefill", "prefill_chunk", "resolve_plan",
    "supports_chunked_prefill", "supports_speculative", "verify_step",
    "KV_CACHE_LEAVES", "cache_leaf_kind",
    "compute_dtype", "init_params", "kv_seq_axis", "model_defs",
    "padded_vocab", "params_from_numpy",
]
