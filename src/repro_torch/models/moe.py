"""Mixture-of-Experts: top-k router and sorted capacity dispatch.

A port of the forward of ``repro.models.moe``: ``moe_apply`` with its
Switch-style load-balance loss, ``_dispatch_one`` and ``_combine_rows`` /
``_combine_one``, and the shared experts.  The custom backward belongs to
training and is left out.

Tokens reshape to ``(dispatch_shards, T_loc, D)`` and each shard routes
on its own, as the reference's ``vmap`` over shards does.  Each expert
takes at most ``C = int(T_loc * K / E * capacity_factor) + 1`` tokens;
the rest are dropped, the same ones the reference drops: the sort is
stable and the group bounds come from a left search, as ``jnp.argsort``
and ``jnp.searchsorted`` give them.

Rounding follows the optimised HLO of the reference's jitted
``moe_block_decode`` under the default XLA flags: the router is an f32
product of the bf16 input and the f32 weight; each expert product is an
f32 product of bf16 operands rounded once to bf16
(``layers._f32_product``); SiLU rounds after every op
(``layers.silu_bf16``); the combine multiplies each kept row by its
bf16-rounded gate in f32, sums the K rows in f32 in order and rounds
once.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import layers

__all__ = ["capacity", "router_probs", "top_k", "route", "dispatch", "combine", "moe_apply"]


def capacity(cfg, t_loc: int) -> int:
    """Slots per expert for ``t_loc`` tokens of a shard."""
    return int(t_loc * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor) + 1


def router_probs(p, xt: torch.Tensor) -> torch.Tensor:
    """xt: (..., D) → the router's softmax (..., E) in f32.

    The logits are a full f32 product.  TF32 stays off (PyTorch's default
    for matmuls): with it the card would round the router's operands to
    10 mantissa bits, and a near-tie between two experts' probabilities
    could then pick another expert than the reference does.
    """
    logits = layers.dense(p["router"], xt, compute_dtype=torch.float32)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def top_k(probs: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs (..., E) → (gate (..., K) f32, renormalised; idx (..., K) int64).

    ``jax.lax.top_k`` puts the lower index first among equal values;
    ``torch.topk`` documents no order for ties, so the top K come from a
    stable descending sort.
    """
    K = cfg.experts_per_token
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :K], idx[..., :K]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    return gate, idx


def route(p, xt: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: (..., D) → (probs (..., E) f32, gate (..., K) f32, idx (..., K) int64)."""
    probs = router_probs(p, xt)
    return (probs,) + top_k(probs, cfg)


def dispatch(xt: torch.Tensor, idx: torch.Tensor, C: int, E: int):
    """One shard: the (E, C, D) expert buffer, gathered slot by slot.

    Returns ``(buf, sort, pos)``: ``sort`` orders the T*K token-expert
    pairs by expert (stable), ``pos`` is each sorted pair's capacity slot
    (-1 where it is dropped).
    """
    T, K = idx.shape
    dev = xt.device
    flat_e = idx.reshape(-1)
    sort = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort]
    bounds = torch.searchsorted(sorted_e, torch.arange(E + 1, device=dev))
    start, end = bounds[:-1], bounds[1:]
    pos_in_group = torch.arange(T * K, device=dev) - start[sorted_e]
    keep = pos_in_group < C
    slot_src = start[:, None] + torch.arange(C, device=dev)[None, :]       # (E, C)
    valid = slot_src < end[:, None]
    src_tok = sort[torch.clamp(slot_src, 0, T * K - 1)] // K
    buf = torch.where(valid[..., None], xt[src_tok], torch.zeros((), dtype=xt.dtype, device=dev))
    pos = torch.where(keep, pos_in_group, torch.full_like(pos_in_group, -1))
    return buf, sort, pos


def combine(out_e: torch.Tensor, sort: torch.Tensor, pos: torch.Tensor,
            idx: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """One shard: each token's kept expert rows, mixed by its gates → (T, D)."""
    T, K = gate.shape
    sorted_e = idx.reshape(-1)[sort]
    keep = pos >= 0
    rows = out_e[sorted_e, torch.where(keep, pos, torch.zeros_like(pos))]
    rows = torch.where(keep[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    rows = rows[torch.argsort(sort)].reshape(T, K, -1).to(torch.float32)
    g = gate.to(out_e.dtype).to(torch.float32)
    y = rows[:, 0] * g[:, 0, None]
    for k in range(1, K):                       # the K rows in order, in f32
        y = y + rows[:, k] * g[:, k, None]
    return y.to(out_e.dtype)


def _experts(we, buf: torch.Tensor) -> torch.Tensor:
    """(E, C, D) → (E, C, D): every expert's SwiGLU on its slots."""
    h = layers._f32_product(buf, we["w_gate"])
    u = layers._f32_product(buf, we["w_up"])
    return layers._f32_product(layers.silu_bf16(h) * u, we["w_down"])


def moe_apply(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y (B, S, D), aux): routed experts plus the shared
    ones, and the load-balance loss ``E * sum(mean probs * mean
    one_hot(top-1 expert))`` over every token of every shard (f32)."""
    B, S, D = x.shape
    E = cfg.n_experts
    DS = max(1, cfg.dispatch_shards)
    T = B * S
    if T % DS:
        raise ValueError(f"{T} tokens do not split into {DS} dispatch shards")
    xt = x.reshape(DS, T // DS, D)
    probs, gate, idx = route(p, xt, cfg)                           # (DS, T_loc, E|K)
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(idx[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    C = capacity(cfg, T // DS)
    ys = []
    for s in range(DS):
        buf, sort, pos = dispatch(xt[s], idx[s], C, E)
        ys.append(combine(_experts(p["experts"], buf), sort, pos, idx[s], gate[s]))
    y = torch.stack(ys)
    if "shared" in p:
        y = y + layers.swiglu(p["shared"], xt)
    return y.reshape(B, S, D).to(x.dtype), aux
