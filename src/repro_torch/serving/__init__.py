"""Serving stack of the port: paged KV cache, the prefix cache and the
continuous-batching engine with chunked prefill and speculative decode."""

from .engine import Request, ServingEngine
from .kv_cache import NULL_PAGE, PagedKVCache
from .prefix_cache import PrefixCache

__all__ = ["Request", "ServingEngine", "NULL_PAGE", "PagedKVCache",
           "PrefixCache"]
