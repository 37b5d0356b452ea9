"""Executable PyTorch model of the port (serving and training entry
points)."""

from .model import (decode_step, forward_hidden, forward_train, prefill,
                    prefill_chunk, resolve_plan, streamed_xent,
                    supports_chunked_prefill, supports_speculative,
                    verify_step)
from .params import (KV_CACHE_LEAVES, abstract_cache, abstract_params,
                     cache_leaf_kind, compute_dtype, init_cache, init_params,
                     kv_seq_axis, model_defs, padded_vocab,
                     params_from_numpy, params_to_numpy)

__all__ = [
    "decode_step", "forward_hidden", "forward_train", "prefill",
    "prefill_chunk", "resolve_plan", "streamed_xent",
    "supports_chunked_prefill", "supports_speculative", "verify_step",
    "KV_CACHE_LEAVES", "abstract_cache", "abstract_params",
    "cache_leaf_kind",
    "compute_dtype", "init_cache", "init_params", "kv_seq_axis",
    "model_defs",
    "padded_vocab", "params_from_numpy", "params_to_numpy",
]
