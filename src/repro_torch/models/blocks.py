"""Transformer block composition for decode (dense family).

Blocks are plain functions over nested-dict params, so the serving ring
can hand each call a freshly decoded layer.
"""

from __future__ import annotations

import torch

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
    # The reference's compiled step (default XLA flags) feeds the MLP norm
    # the f32 sum x + a, dropping the bf16 round of the residual before the
    # norm's f32 cast (its HLO: the f32 ``add`` of ``copy_add_fusion`` goes
    # straight to the norm's ``multiply`` and ``reduce-window``); the
    # residual stream itself is rounded, as the next ``add`` consumes it.
    xs = x.to(torch.float32) + a                # a widens inside the add, exactly
    h = norm_apply(cfg, p["mlp_norm"], xs).to(x.dtype)
    x = xs.to(x.dtype) + mlp_apply(cfg, p["mlp"], h)
    return x, (ck, cv)
