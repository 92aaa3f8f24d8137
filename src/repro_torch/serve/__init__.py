"""Serving: the compressed-resident param store, the KV tier, prefill and
the decode steps."""

from .compressed import CompressedParamStore
from .kvcache import KVCacheStore
from .step import (
    greedy_generate,
    make_compressed_serve_step,
    make_kv_tiered_serve_step,
    make_prefill,
    make_serve_step,
)

__all__ = [
    "CompressedParamStore",
    "KVCacheStore",
    "greedy_generate",
    "make_compressed_serve_step",
    "make_kv_tiered_serve_step",
    "make_prefill",
    "make_serve_step",
]
