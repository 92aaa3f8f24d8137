"""Mixture-of-Experts: top-k router and sorted capacity dispatch.

A port of ``repro.models.moe``: ``moe_apply`` with its Switch-style
load-balance loss, ``_dispatch_one`` and ``_combine_rows`` /
``_combine_one`` (with the custom backward of ``_combine_one_bwd``, and a
deterministic backward for the dispatch gather), and the shared experts.
The router, the top-k gates and the aux loss differentiate by autograd.

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

On DTensors over a mesh (``launch/dryrun.py``) the dispatch is the
reference's shard-local one: the (dispatch_shards, T_loc, D) tokens lie
over the batch axes, and each rank routes, dispatches and combines its
own rows on its local tensors (:func:`_moe_apply_mesh`); the reference's
``lshard`` sites lay the expert buffer out over the experts' axis and
back, which puts the token all-to-all (or its slice and all-gather) at
the dispatch and combine boundaries.  Plain tensors take the loop below.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..distributed.sharding import from_local_like, is_dtensor, local_tensor, lshard
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


def _slots(sorted_e: torch.Tensor, E: int, C: int, TK: int):
    """Each expert's group bounds in the sorted pairs, and for slot (e, c)
    its sorted pair ``start[e] + c`` (clipped) and whether it is live."""
    dev = sorted_e.device
    bounds = torch.searchsorted(sorted_e, torch.arange(E + 1, device=dev))
    start, end = bounds[:-1], bounds[1:]
    slot_src = start[:, None] + torch.arange(C, device=dev)[None, :]       # (E, C)
    valid = slot_src < end[:, None]
    return start, torch.clamp(slot_src, 0, TK - 1), valid


def _route_pairs(idx: torch.Tensor, C: int, E: int):
    """``(sort, pos, slot_src, valid)`` of one shard's (T, K) expert
    choices: the stable sort of the T*K pairs by expert, each sorted
    pair's capacity slot (-1 where dropped), and each slot's pair."""
    T, K = idx.shape
    flat_e = idx.reshape(-1)
    sort = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort]
    start, slot_src, valid = _slots(sorted_e, E, C, T * K)
    pos_in_group = torch.arange(T * K, device=idx.device) - start[sorted_e]
    pos = torch.where(pos_in_group < C, pos_in_group, torch.full_like(pos_in_group, -1))
    return sort, pos, slot_src, valid


class _Dispatch(torch.autograd.Function):
    """``buf[e, c] = xt[token of slot (e, c)]`` (0 in empty slots), with a
    deterministic backward.

    Each token's gradient is the sum of the rows of the (at most K) live
    slots that hold it, added one at a time in slot order (the sorted
    pairs' order: expert by expert, ascending) from 0, every add rounded
    to xt's dtype.  That is the order and precision of ``jax.grad`` of the
    reference's ``_dispatch_one`` on the CPU (its gather's transpose, a
    scatter-add over the slots in order, in bf16), bit for bit.  Plain
    autograd would differentiate ``xt[src_tok]`` into
    ``index_put_(accumulate=True)``, which sums on the card in an order
    that changes from run to run.
    """

    @staticmethod
    def forward(ctx, xt, sort, slot_src, valid, K):
        src_tok = sort[slot_src] // K
        buf = torch.where(valid[..., None], xt[src_tok],
                          torch.zeros((), dtype=xt.dtype, device=xt.device))
        ctx.save_for_backward(sort, slot_src, valid)
        ctx.shape = (xt.shape[0], K)
        return buf

    @staticmethod
    def backward(ctx, dbuf):
        sort, slot_src, valid = ctx.saved_tensors
        T, K = ctx.shape
        E, C, D = dbuf.shape
        # each sorted pair's row: the slot that holds it, or 0 (dropped).
        # A live slot's pair is its own; the empty slots all write one
        # spare row, dropped after (no shape here depends on the data)
        rows = torch.zeros((T * K + 1, D), dtype=dbuf.dtype, device=dbuf.device)
        dst = torch.where(valid.reshape(-1), slot_src.reshape(-1), T * K)
        rows[dst] = dbuf.reshape(E * C, D)
        rows = rows[:T * K]
        # each token's K pairs in sorted order, added in that order
        rank = torch.empty_like(sort)
        rank[sort] = torch.arange(T * K, device=sort.device)
        picked = rows[torch.sort(rank.reshape(T, K), dim=1).values]      # (T, K, D)
        dx = picked[:, 0]
        for j in range(1, K):
            dx = dx + picked[:, j]
        return dx, None, None, None, None


def dispatch(xt: torch.Tensor, idx: torch.Tensor, C: int, E: int):
    """One shard: the (E, C, D) expert buffer, gathered slot by slot.

    Returns ``(buf, sort, pos)``: ``sort`` orders the T*K token-expert
    pairs by expert (stable), ``pos`` is each sorted pair's capacity slot
    (-1 where it is dropped).  Differentiable in ``xt`` (:class:`_Dispatch`).
    """
    sort, pos, slot_src, valid = _route_pairs(idx, C, E)
    return _Dispatch.apply(xt, sort, slot_src, valid, idx.shape[1]), sort, pos


def _combine_rows(out_e, sort, pos, idx):
    """(T, K, D): each token's K expert rows in its top-k order (0 where
    the pair was dropped)."""
    T, K = idx.shape
    sorted_e = idx.reshape(-1)[sort]
    keep = pos >= 0
    rows = out_e[sorted_e, torch.where(keep, pos, torch.zeros_like(pos))]
    rows = torch.where(keep[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return rows[torch.argsort(sort)].reshape(T, K, -1)


class _Combine(torch.autograd.Function):
    """The gate-weighted mix of each token's expert rows, with the
    reference's ``_combine_one_bwd``: ``d_gate`` from the recomputed rows
    times ``dy`` in f32, cast to the gate's dtype; ``d_out_e`` a gather of
    ``dy * bf16(gate)`` (bf16) into the live slots, 0 elsewhere."""

    @staticmethod
    def forward(ctx, out_e, sort, pos, idx, gate):
        T, K = gate.shape
        rows = _combine_rows(out_e, sort, pos, idx).to(torch.float32)
        g = gate.to(out_e.dtype).to(torch.float32)
        y = rows[:, 0] * g[:, 0, None]
        for k in range(1, K):                       # the K rows in order, in f32
            y = y + rows[:, k] * g[:, k, None]
        ctx.save_for_backward(out_e, sort, pos, idx, gate)
        return y.to(out_e.dtype)

    @staticmethod
    def backward(ctx, dy):
        out_e, sort, pos, idx, gate = ctx.saved_tensors
        T, K = gate.shape
        E, C, D = out_e.shape
        rows = _combine_rows(out_e, sort, pos, idx)
        d_gate = (rows.to(torch.float32) * dy.to(torch.float32)[:, None, :]).sum(-1)
        d_rows = (dy[:, None, :] * gate.to(dy.dtype)[..., None]).reshape(T * K, D)
        keep = (pos >= 0)[:, None]
        d_sorted = torch.where(keep, d_rows[sort], torch.zeros((), dtype=dy.dtype,
                                                              device=dy.device))
        _, slot_src, valid = _slots(idx.reshape(-1)[sort], E, C, T * K)
        d_out_e = torch.where(valid[..., None], d_sorted[slot_src],
                              torch.zeros((), dtype=dy.dtype, device=dy.device))
        return d_out_e.to(out_e.dtype), None, None, None, d_gate.to(gate.dtype)


def combine(out_e: torch.Tensor, sort: torch.Tensor, pos: torch.Tensor,
            idx: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """One shard: each token's kept expert rows, mixed by its gates → (T, D).
    Differentiable in ``out_e`` and ``gate`` (:class:`_Combine`)."""
    return _Combine.apply(out_e, sort, pos, idx, gate)


def _experts(we, buf: torch.Tensor) -> torch.Tensor:
    """(E, C, D) → (E, C, D): every expert's SwiGLU on its slots."""
    h = layers._f32_product(buf, we["w_gate"])
    u = layers._f32_product(buf, we["w_up"])
    return layers._f32_product(layers.silu_bf16(h) * u, we["w_down"])


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(idx[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    return E * torch.sum(me * ce)


_FF_DIM = {"w_gate": 2, "w_up": 2, "w_down": 1}      # (E, D, F) / (E, F, D)


def _expert_weight_placements(buf_pl, w, ff_dim: int):
    """An expert leaf's placements for the local product with a buffer
    laid out as ``buf_pl``: its experts where the buffer has its experts,
    its own ff cut where the buffer is whole, replicated elsewhere (so a
    ZeRO-3 cut of d_model is gathered)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for bp, wp in zip(buf_pl, w.placements):
        if bp.is_shard(1):
            out.append(Shard(0))
        elif bp.is_replicate() and wp.is_shard(ff_dim):
            out.append(wp)
        else:
            out.append(Replicate())
    return out


def _summed_over(pl, cut):
    """``pl`` with a partial sum on each mesh axis where ``cut`` holds: the
    placements of a local gradient that each rank sums over its own part
    of the work (its tokens, its ff columns)."""
    from torch.distributed.tensor import Partial

    return [Partial() if c else p for p, c in zip(pl, cut)]


SERVING_TOKENS = 4096      # the reference's: fewer tokens a shard take the serving layout


def _moe_apply_mesh(p, xt: torch.Tensor, cfg):
    """The routed experts on DTensors: ``xt`` (DS, T_loc, D) over the batch
    axes.  Returns ((DS, T_loc, D), aux)."""
    from torch.distributed.tensor import Partial, Replicate

    DS, T_loc, D = xt.shape
    E = cfg.n_experts
    C = capacity(cfg, T_loc)
    xt = lshard(xt, "batch", None, None)
    mesh = xt.device_mesh
    rows_pl = list(xt.placements)                       # Shard(0) on the batch axes
    tokens_cut = [pl.is_shard() for pl in rows_pl]
    router = p["router"]["w"].redistribute(mesh, [Replicate()] * len(rows_pl))

    def route_local(x_loc, w_loc):
        probs, gate, idx = route({"router": {"w": w_loc}}, x_loc, cfg)
        bufs, sorts, poss = [], [], []
        for s in range(x_loc.shape[0]):
            buf, sort, pos = dispatch(x_loc[s], idx[s], C, E)
            bufs.append(buf)
            sorts.append(sort)
            poss.append(pos)
        return probs, gate, idx, torch.stack(bufs), torch.stack(sorts), torch.stack(poss)

    # each rank routes its own tokens: the router's gradient sums over them
    outs = route_local(local_tensor(xt, rows_pl),
                       local_tensor(router, _summed_over(router.placements, tokens_cut)))
    probs, gate, idx, buf, sort, pos = (from_local_like(t, xt, rows_pl) for t in outs)
    aux = _aux_loss(probs, idx, E)

    # the scatter stays token-sharded; then the experts' layout, adapted to
    # the token count as the reference's: experts over 'model' in training,
    # over 'data' (the serving weights' layout) for a few decode tokens
    buf = lshard(buf, "batch", None, None, None)
    serving = T_loc < SERVING_TOKENS
    e_axis = "experts_serve" if serving else "experts"
    buf_e = lshard(buf, None if serving else "batch", e_axis, None, None)
    we = p["experts"]
    w = {k: we[k].redistribute(mesh, _expert_weight_placements(buf_e.placements, we[k], d))
         for k, d in _FF_DIM.items()}
    out_pl = []
    for bp, dp in zip(buf_e.placements, w["w_down"].placements):
        out_pl.append(bp if bp.is_shard() else Partial() if dp.is_shard(1) else Replicate())
    # the gradients: a weight whole over an axis that cuts the buffer's
    # tokens sums its rows' gradients over it; the buffer's sums over an
    # axis that cuts the ff width
    buf_cut = [bp.is_shard(0) for bp in buf_e.placements]
    ff_cut = [bp.is_replicate() and wp.is_shard(2)
              for bp, wp in zip(buf_e.placements, w["w_gate"].placements)]
    out_e = from_local_like(
        _experts({k: local_tensor(v, _summed_over(v.placements, buf_cut)) for k, v in w.items()},
                 local_tensor(buf_e, _summed_over(buf_e.placements, ff_cut))),
        buf_e, out_pl)
    if serving:
        out_e = lshard(out_e, None, e_axis, None, None)
    else:
        out_e = lshard(out_e, "batch", None, None, None)

    out_e = lshard(out_e, "batch", None, None, None)    # rows back to their tokens
    loc = [local_tensor(t, rows_pl) for t in (out_e, sort, pos, idx, gate)]
    y = torch.stack([combine(loc[0][s], loc[1][s], loc[2][s], loc[3][s], loc[4][s])
                     for s in range(loc[0].shape[0])])
    return lshard(from_local_like(y, xt, rows_pl), "batch", None, None), aux


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
    if is_dtensor(xt):
        y, aux = _moe_apply_mesh(p, xt, cfg)
    else:
        probs, gate, idx = route(p, xt, cfg)                       # (DS, T_loc, E|K)
        aux = _aux_loss(probs, idx, E)
        C = capacity(cfg, T // DS)
        ys = []
        for s in range(DS):
            buf, sort, pos = dispatch(xt[s], idx[s], C, E)
            ys.append(combine(_experts(p["experts"], buf), sort, pos, idx[s], gate[s]))
        y = torch.stack(ys)
    if "shared" in p:
        y = y + layers.swiglu(p["shared"], xt)
    return y.reshape(B, S, D).to(x.dtype), aux
