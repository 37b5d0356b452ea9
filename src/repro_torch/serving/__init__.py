"""Serving stack of the port: paged KV cache and the continuous-batching
engine with chunked prefill."""

from .engine import Request, ServingEngine
from .kv_cache import NULL_PAGE, PagedKVCache

__all__ = ["Request", "ServingEngine", "NULL_PAGE", "PagedKVCache"]
