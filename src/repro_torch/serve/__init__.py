"""Serving: the compressed-resident param store and the decode steps."""

from .compressed import CompressedParamStore
from .step import greedy_generate, make_compressed_serve_step, make_serve_step

__all__ = [
    "CompressedParamStore",
    "greedy_generate",
    "make_compressed_serve_step",
    "make_serve_step",
]
