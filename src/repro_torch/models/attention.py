"""Attention: the blockwise flash forward and the dense variant over a
whole sequence (forward and prefill), and the caches and one-token GQA
and MLA decode.

A port of ``repro.models.attention``: ``_block_mask``,
``_flash_fwd_impl`` / ``flash_attention`` (the forward only: there is no
backward here), ``dense_attention``, ``_attend``, ``_qkv`` /
``gqa_train``, ``_mla_qkv`` / ``mla_train``, ``init_kv_cache``,
``gqa_decode``, ``init_mla_cache`` and ``mla_decode``.  The caches are
read-only in the decode functions; the caller writes every layer's
new-token slot once after the layer loop.

The flash loop keeps the reference's rounding points: ``q`` scaled in
bf16 (by the bf16 value of ``hd ** -0.5``, as JAX's weakly typed scalar
becomes), f32 scores, masked entries set to ``NEG_INF``, the online max,
sum and correction in f32, ``p`` rounded to the value dtype before the PV
product (accumulated in f32), and ``acc / max(l, 1e-30)`` rounded to
bf16.  Its score buffer is one (B, G, rep, q_block, kv_block) f32 block
at a time.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from . import layers

__all__ = [
    "NEG_INF", "flash_attention", "dense_attention", "gqa_train", "mla_train",
    "KVCache", "init_kv_cache", "gqa_decode", "init_mla_cache", "mla_decode",
]

NEG_INF = -1e30


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _bf16_scale(hd: int) -> float:
    """``hd ** -0.5`` as the bf16 value a bf16 array multiplies by in JAX
    (a weakly typed Python scalar takes the array's dtype)."""
    return float(torch.tensor(hd ** -0.5, dtype=torch.bfloat16))


def _qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor, pos_thw=None):
    """q (B, S, H, hd), k and v (B, S, G, hd): the projections (with their
    biases where the config has them), then M-RoPE at ``pos_thw`` (B, S, 3)
    where the config has M-RoPE and one is given, else RoPE at
    ``positions`` (B, S) where the config uses it (a ``pos_thw`` given to
    a config without M-RoPE is ignored, as in the reference)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = layers.dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = layers.dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = layers.dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.mrope and pos_thw is not None:
        q = layers.apply_mrope(q, pos_thw, cfg.rope_theta, cfg.mrope_sections)
        k = layers.apply_mrope(k, pos_thw, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_mask(qpos: torch.Tensor, kpos: torch.Tensor, S: int, causal: bool,
                window: int) -> torch.Tensor:
    mask = kpos[None, :] < S                       # padding
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def _block_live(q0: int, q1: int, k0: int, k1: int, S: int, causal: bool, window: int) -> bool:
    """Whether any (query, key) pair of rows ``[q0, q1)`` and keys
    ``[k0, k1)`` is unmasked.  A block with none changes no row the
    reference keeps: where a row's max is finite its ``p`` is 0 and its
    correction 1, and where it is still ``NEG_INF`` the next live block's
    correction of 0 clears what it added.  So it is skipped."""
    if k0 >= S:
        return False
    if causal and k0 > q1 - 1:
        return False
    return not (window > 0 and k1 - 1 <= q0 - window)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int = 0,
    q_block: int = 512, kv_block: int = 1024,
) -> torch.Tensor:
    """Blockwise online-softmax attention, the forward of the reference's
    ``flash_attention``.

    q: (B, S, H, hd); k: (B, S, G, hd); v: (B, S, G, hd_v) with H % G == 0
    (hd_v may differ from hd: MLA has 192-wide qk and 128-wide v).
    ``window > 0`` keeps keys with ``kpos > qpos - window``.  Blocks are
    ``min(q_block, S)`` and ``min(kv_block, S)``, q/k/v zero-padded to a
    whole number of them; each q block runs its kv blocks in order.
    Returns (B, S, H, hd_v) in q's dtype.
    """
    B, S, H, hd = q.shape
    G, hd_v = k.shape[2], v.shape[-1]
    rep = H // G
    qb_len, kb_len = min(q_block, S), min(kv_block, S)
    pad_q, pad_k = (-S) % qb_len, (-S) % kb_len
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    Sq, Sk = S + pad_q, S + pad_k
    dev = q.device
    # (B, G, rep, S, hd) queries scaled in bf16; (B, G, S, hd) keys, values
    qs = (q * _bf16_scale(hd)).reshape(B, Sq, G, rep, hd).permute(0, 2, 3, 1, 4)
    kt = _f32(k.permute(0, 2, 1, 3))
    vt = v.permute(0, 2, 1, 3)
    out = torch.empty((B, G, rep, Sq, hd_v), dtype=q.dtype, device=dev)
    for q0 in range(0, Sq, qb_len):
        q1 = q0 + qb_len
        qb = _f32(qs[:, :, :, q0:q1]).reshape(B, G, rep * qb_len, hd)
        qpos = torch.arange(q0, q1, device=dev)
        m = torch.full((B, G, rep, qb_len), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, G, rep, qb_len), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, G, rep, qb_len, hd_v), dtype=torch.float32, device=dev)
        for k0 in range(0, Sk, kb_len):
            k1 = k0 + kb_len
            if not _block_live(q0, q1, k0, k1, S, causal, window):
                continue
            s = torch.matmul(qb, kt[:, :, k0:k1].transpose(-1, -2))
            s = s.reshape(B, G, rep, qb_len, kb_len)
            mask = _block_mask(qpos, torch.arange(k0, k1, device=dev), S, causal, window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.matmul(_f32(p.to(v.dtype)).reshape(B, G, rep * qb_len, kb_len),
                              _f32(vt[:, :, k0:k1]))
            acc = acc * corr[..., None] + pv.reshape(B, G, rep, qb_len, hd_v)
            m = m_new
        out[:, :, :, q0:q1] = (acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)
    return out[:, :, :, :S].reshape(B, H, S, hd_v).transpose(1, 2)


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int = 0
) -> torch.Tensor:
    """Unblocked masked attention, the reference's ``dense_attention``:
    ``q`` scaled in bf16, f32 scores and softmax, the weights rounded to
    the value dtype before the PV product, the output rounded to q's."""
    B, S, H, hd = q.shape
    G = k.shape[2]
    rep = H // G
    qr = _f32(q.reshape(B, S, G, rep, hd) * _bf16_scale(hd))
    s = torch.einsum("bqgrd,bkgd->bgrqk", qr, _f32(k))
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", _f32(w.to(v.dtype)), _f32(v)).to(q.dtype)
    return out.reshape(B, S, H, v.shape[-1])


def _attend(q, k, v, cfg, *, causal: bool) -> torch.Tensor:
    if cfg.attn_impl == "dense":
        return dense_attention(q, k, v, causal=causal, window=cfg.window)
    return flash_attention(q, k, v, causal=causal, window=cfg.window,
                           q_block=cfg.q_block, kv_block=cfg.kv_block)


def gqa_train(p, x: torch.Tensor, cfg, positions: torch.Tensor, pos_thw=None) -> torch.Tensor:
    """GQA over a whole sequence: x (B, S, D) → (B, S, D)."""
    q, k, v = _qkv(p, x, cfg, positions, pos_thw)
    out = _attend(q, k, v, cfg, causal=not cfg.encoder_only)
    B, S = x.shape[:2]
    return layers.dense(p["wo"], out.reshape(B, S, -1))


def _mla_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """MLA's q_full (B, S, H, dn + dr), k_full (the shared rope key
    broadcast to every head) and value (B, S, H, dv), and the latent
    c_kv (B, S, r) and rope key (B, S, 1, dr) a cache would hold."""
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cq = layers.rmsnorm(p["q_norm"], layers.dense(p["w_dq"], x))
    q = layers.dense(p["w_uq"], cq).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = layers.rmsnorm(p["kv_norm"], layers.dense(p["w_dkv"], x))
    k_rope = layers.dense(p["w_kr"], x).reshape(B, S, 1, dr)
    k_rope = layers.apply_rope(k_rope, positions, cfg.rope_theta)
    k_nope = layers.dense(p["w_uk"], c_kv).reshape(B, S, H, dn)
    val = layers.dense(p["w_uv"], c_kv).reshape(B, S, H, dv)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    return q_full, k_full, val, c_kv, k_rope


def mla_train(p, x: torch.Tensor, cfg, positions: torch.Tensor) -> torch.Tensor:
    """MLA over a whole sequence: causal attention of the 192-wide (at
    published widths) q/k against the 128-wide value."""
    q, k, v, _, _ = _mla_qkv(p, x, cfg, positions)
    out = _attend(q, k, v, cfg, causal=True)
    B, S = x.shape[:2]
    return layers.dense(p["wo"], out.reshape(B, S, -1))


class KVCache(NamedTuple):
    k: torch.Tensor      # (L_layers, B, L, G, hd)
    v: torch.Tensor


def init_kv_cache(cfg, batch: int, length: int, n_layers: int, device) -> KVCache:
    shape = (n_layers, batch, length, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        torch.zeros(shape, dtype=torch.bfloat16, device=device),
        torch.zeros(shape, dtype=torch.bfloat16, device=device),
    )


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
