"""Transformer block composition for decode (dense family).

Blocks are plain functions over nested-dict params, so the serving ring
can hand each call a freshly decoded layer.
"""

from __future__ import annotations

from . import attention, layers

__all__ = ["norm_apply", "mlp_apply", "dense_block_decode"]


def norm_apply(cfg, p, x):
    fn = layers.layernorm if cfg.norm == "layernorm" else layers.rmsnorm
    return fn(p, x, cfg.norm_eps)


def mlp_apply(cfg, p, x):
    return (layers.gelu_mlp if cfg.mlp == "gelu" else layers.swiglu)(p, x)


def dense_block_decode(p, x, caches, pos, cfg):
    if cfg.mla:
        raise NotImplementedError("MLA attention is not ported yet")
    h = norm_apply(cfg, p["attn_norm"], x)
    a, ck, cv = attention.gqa_decode(p["attn"], h, caches[0], caches[1], pos, cfg)
    x = x + a
    h = norm_apply(cfg, p["mlp_norm"], x)
    x = x + mlp_apply(cfg, p["mlp"], h)
    return x, (ck, cv)
