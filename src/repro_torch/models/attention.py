"""Attention for decode: the caches and one-token GQA and MLA decode.

A port of ``repro.models.attention``'s ``init_kv_cache``, ``gqa_decode``,
``init_mla_cache`` and ``mla_decode``.  The caches are read-only here;
the caller writes every layer's new-token slot once after the layer
loop.  The training/prefill attention comes with a later slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from . import layers

__all__ = ["NEG_INF", "KVCache", "init_kv_cache", "gqa_decode", "init_mla_cache", "mla_decode"]

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


def init_mla_cache(cfg, batch: int, length: int, n_layers: int, device) -> Dict[str, torch.Tensor]:
    """MLA caches the compressed latent and the shared rope key:
    ``kv_lora_rank + qk_rope_dim`` values a token instead of ``2 * H * hd``."""
    return {
        "c_kv": torch.zeros((n_layers, batch, length, cfg.kv_lora_rank),
                            dtype=torch.bfloat16, device=device),
        "k_rope": torch.zeros((n_layers, batch, length, cfg.qk_rope_dim),
                              dtype=torch.bfloat16, device=device),
    }


def _bf16_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(..., preferred_element_type=f32)`` of bf16 operands: the
    operands cast to f32 (exact) and multiplied in f32."""
    return torch.einsum(eq, _f32(a.to(torch.bfloat16)), _f32(b.to(torch.bfloat16)))


def mla_decode(
    p, x: torch.Tensor, c_kv_cache: torch.Tensor, k_rope_cache: torch.Tensor,
    pos: torch.Tensor, cfg,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed-matmul decode: scores and context in the latent space.

    x: (B, 1, D); c_kv_cache: (B, L, r); k_rope_cache: (B, L, dr).
    Returns (out (B, 1, D), c_kv_new (B, 1, r), k_rope_new (B, 1, dr)) for
    the caller's single slot write.  ``w_uk`` is absorbed into the query
    in f32; the score and context products are f32 products of bf16
    operands; the new token attends to itself through an extra score
    column, and the ring-buffer mask is ``gqa_decode``'s.
    """
    B = x.shape[0]
    H, dn, dr, dv, r = (
        cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    )
    L = c_kv_cache.shape[1]
    cq = layers.rmsnorm(p["q_norm"], layers.dense(p["w_dq"], x))
    q = layers.dense(p["w_uq"], cq).reshape(B, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    posb = pos.to(torch.int32).expand(B, 1)
    q_rope = layers.apply_rope(q_rope.reshape(B, 1, H, dr), posb, cfg.rope_theta).reshape(B, H, dr)

    c_kv_new = layers.rmsnorm(p["kv_norm"], layers.dense(p["w_dkv"], x))      # (B, 1, r)
    k_rope_new = layers.apply_rope(
        layers.dense(p["w_kr"], x).reshape(B, 1, 1, dr), posb, cfg.rope_theta
    ).reshape(B, 1, dr)
    slot = pos % L

    w_uk = _f32(p["w_uk"]["w"].reshape(r, H, dn))
    q_lat = torch.einsum("bhn,rhn->bhr", _f32(q_nope), w_uk).to(torch.bfloat16)
    s = _bf16_product("bhr,blr->bhl", q_lat, c_kv_cache)
    s = s + _bf16_product("bhd,bld->bhl", q_rope, k_rope_cache)
    s_self = _bf16_product("bhr,bor->bho", q_lat, c_kv_new)
    s_self = s_self + _bf16_product("bhd,bod->bho", q_rope, k_rope_new)

    scale = (dn + dr) ** -0.5
    idx = torch.arange(L, device=x.device)
    written = torch.where(pos >= L, idx != slot, idx < pos)
    s = torch.where(written[None, None, :], s * scale, NEG_INF)
    s_self = s_self * scale
    lse = torch.logaddexp(
        torch.logsumexp(s, dim=-1, keepdim=True),
        torch.logsumexp(s_self, dim=-1, keepdim=True),
    )
    w_cache = torch.exp(s - lse)
    w_self = torch.exp(s_self - lse)
    ctx_lat = _bf16_product("bhl,blr->bhr", w_cache, c_kv_cache)
    ctx_lat = ctx_lat + _bf16_product("bho,bor->bhr", w_self, c_kv_new)
    w_uv = p["w_uv"]["w"].reshape(r, H, dv)
    ctx = _bf16_product("bhr,rhv->bhv", ctx_lat, w_uv).to(torch.bfloat16)
    out = layers.dense(p["wo"], ctx.reshape(B, 1, H * dv))
    return out, c_kv_new.to(c_kv_cache.dtype), k_rope_new.to(k_rope_cache.dtype)
