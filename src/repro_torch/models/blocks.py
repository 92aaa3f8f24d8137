"""Block composition: transformer (dense and MoE families) and Mamba2
(SSM and hybrid families), over a whole sequence (``*_train``: the
forward and prefill) and for one decode step (``*_decode``).

Blocks are plain functions over nested-dict params, so the serving ring
can hand each call a freshly decoded layer.  Every ``*_train`` block
returns ``(x, aux)``: aux is the MoE load-balance loss, 0 elsewhere.
"""

from __future__ import annotations

import torch

from .. import trace
from . import attention, layers, moe, ssm

__all__ = ["norm_apply", "mlp_apply", "dense_block_train", "moe_block_train",
           "mamba_block_train", "dense_block_decode", "moe_block_decode",
           "mamba_block_decode"]


def norm_apply(cfg, p, x):
    fn = layers.layernorm if cfg.norm == "layernorm" else layers.rmsnorm
    return fn(p, x, cfg.norm_eps)


def mlp_apply(cfg, p, x):
    return (layers.gelu_mlp if cfg.mlp == "gelu" else layers.swiglu)(p, x)


def _attend_seq(p, x, cfg, positions, pos_thw=None):
    """Attention norm and GQA or MLA over the sequence: x + a in f32, fed
    to the MLP norm unrounded as in ``_attend`` below."""
    h = norm_apply(cfg, p["attn_norm"], x)
    if cfg.mla:
        a = attention.mla_train(p["attn"], h, cfg, positions)
    else:
        a = attention.gqa_train(p["attn"], h, cfg, positions, pos_thw)
    return x.to(torch.float32) + a


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def dense_block_train(p, x, cfg, positions, pos_thw=None):
    xs = _attend_seq(p, x, cfg, positions, pos_thw)
    h = norm_apply(cfg, p["mlp_norm"], xs).to(x.dtype)
    return xs.to(x.dtype) + mlp_apply(cfg, p["mlp"], h), _zero(x)


def moe_block_train(p, x, cfg, positions, pos_thw=None):
    xs = _attend_seq(p, x, cfg, positions, pos_thw)
    h = norm_apply(cfg, p["mlp_norm"], xs).to(x.dtype)
    y, aux = moe.moe_apply(p["moe"], h, cfg)
    return xs.to(x.dtype) + y, aux


def mamba_block_train(p, x, cfg, positions=None, pos_thw=None):
    h = norm_apply(cfg, p["norm"], x)
    return x + ssm.mamba2_train(p["mamba"], h, cfg), _zero(x)


def _attend(p, x, caches, pos, cfg):
    """Attention norm and GQA or MLA decode: (x + a in f32, new caches)."""
    h = norm_apply(cfg, p["attn_norm"], x)
    fn = attention.mla_decode if cfg.mla else attention.gqa_decode
    a, c0, c1 = fn(p["attn"], h, caches[0], caches[1], pos, cfg)
    # The reference's compiled step (default XLA flags) feeds the MLP norm
    # the f32 sum x + a, dropping the bf16 round of the residual before the
    # norm's f32 cast (its HLO: the f32 ``add`` of ``copy_add_fusion`` goes
    # straight to the norm's ``multiply`` and ``reduce-window``); the
    # residual stream itself is rounded, as the next ``add`` consumes it.
    # The MoE block's HLO has the same fusion.
    return x.to(torch.float32) + a, (c0, c1)    # a widens inside the add, exactly


def dense_block_decode(p, x, caches, pos, cfg):
    with trace.span("model.attention"):
        xs, new_caches = _attend(p, x, caches, pos, cfg)
    with trace.span("model.mlp"):
        h = norm_apply(cfg, p["mlp_norm"], xs).to(x.dtype)
        x = xs.to(x.dtype) + mlp_apply(cfg, p["mlp"], h)
    return x, new_caches


def moe_block_decode(p, x, caches, pos, cfg):
    """Attention, then the routed (and shared) experts; the aux loss is
    dropped.  The output rounds as the HLO's ``add_convert_fusion``:
    ``bf16(bf16(x + a) + y)``, ``y`` the bf16 expert mix (plus the bf16
    shared output, added and rounded first)."""
    with trace.span("model.attention"):
        xs, new_caches = _attend(p, x, caches, pos, cfg)
    with trace.span("model.mlp"):
        h = norm_apply(cfg, p["mlp_norm"], xs).to(x.dtype)
        y, _ = moe.moe_apply(p["moe"], h, cfg)
        return xs.to(x.dtype) + y, new_caches


def mamba_block_decode(p, x, caches, pos, cfg):
    """Norm, then the Mamba2 recurrence; ``caches`` is (ssm state, conv
    history).  The output rounds as the HLO's ``add_convert_fusion``:
    ``bf16(x + y)``, ``y`` the bf16 ``out_proj``."""
    h = norm_apply(cfg, p["norm"], x)
    y, state, conv = ssm.mamba2_decode(p["mamba"], h, caches[0], caches[1], cfg)
    return x + y, (state, conv)
