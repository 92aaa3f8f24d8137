"""Attention for decode: the KV cache and one-token GQA decode.

A port of ``repro.models.attention``'s ``init_kv_cache`` and
``gqa_decode``.  The cache is read-only here; the caller writes every
layer's new-token slot once after the layer loop.  MLA and the
training/prefill attention come with later model families.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import layers

__all__ = ["NEG_INF", "KVCache", "init_kv_cache", "gqa_decode"]

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor      # (L_layers, B, L, G, hd)
    v: torch.Tensor


def init_kv_cache(cfg, batch: int, length: int, n_layers: int, device) -> KVCache:
    shape = (n_layers, batch, length, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        torch.zeros(shape, dtype=torch.bfloat16, device=device),
        torch.zeros(shape, dtype=torch.bfloat16, device=device),
    )


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def gqa_decode(
    p, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
    pos: torch.Tensor, cfg,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, D); cache_[kv]: (B, L, G, hd); pos: int32[].

    Returns (out (B, 1, D), k_new (B, 1, G, hd), v_new).  The new token
    attends to itself through an explicit extra score column; the cache
    is a ring buffer that wraps at L, and the stale slot being replaced is
    masked out.
    """
    B = x.shape[0]
    hd = cfg.head_dim
    L = cache_k.shape[1]
    q = layers.dense(p["wq"], x).reshape(B, 1, cfg.n_heads, hd)
    k = layers.dense(p["wk"], x).reshape(B, 1, cfg.n_kv_heads, hd)
    v = layers.dense(p["wv"], x).reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.use_rope:
        posb = pos.to(torch.int32).expand(B, 1)
        q = layers.apply_rope(q, posb, cfg.rope_theta)
        k = layers.apply_rope(k, posb, cfg.rope_theta)

    G = cfg.n_kv_heads
    rep = cfg.n_heads // G
    slot = pos % L
    qr = q.reshape(B, G, rep, hd) * hd ** -0.5
    s = torch.einsum("bgrd,blgd->bgrl", _f32(qr), _f32(cache_k))
    s_self = torch.einsum("bgrd,bogd->bgro", _f32(qr), _f32(k))
    idx = torch.arange(L, device=x.device)
    written = torch.where(pos >= L, idx != slot, idx < pos)
    s = torch.where(written[None, None, None, :], s, NEG_INF)
    lse_c = torch.logsumexp(s, dim=-1, keepdim=True)
    lse = torch.logaddexp(lse_c, torch.logsumexp(s_self, dim=-1, keepdim=True))
    w_cache = torch.exp(s - lse)
    w_self = torch.exp(s_self - lse)
    ctx = torch.einsum(
        "bgrl,blgd->bgrd", _f32(w_cache.to(cache_v.dtype)), _f32(cache_v)
    )
    ctx = ctx + torch.einsum("bgro,bogd->bgrd", _f32(w_self.to(v.dtype)), _f32(v))
    out = layers.dense(p["wo"], ctx.reshape(B, 1, cfg.n_heads * hd).to(x.dtype))
    return out, k.to(cache_k.dtype), v.to(cache_v.dtype)
