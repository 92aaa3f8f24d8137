"""Serving: the compressed-resident param store, the KV tier, prefill,
the decode steps and the serving layouts (param and decode-state
specs)."""

from .compressed import CompressedParamStore
from .kvcache import KVCacheStore
from .step import (
    decode_state_specs,
    greedy_generate,
    inference_param_specs,
    make_compressed_serve_step,
    make_kv_tiered_serve_step,
    make_prefill,
    make_serve_step,
)

__all__ = [
    "CompressedParamStore",
    "KVCacheStore",
    "decode_state_specs",
    "greedy_generate",
    "inference_param_specs",
    "make_compressed_serve_step",
    "make_kv_tiered_serve_step",
    "make_prefill",
    "make_serve_step",
]
