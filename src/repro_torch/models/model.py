"""Decode state and the one-token decode step for the dense family.

A port of ``repro.models.model``'s ``init_decode_state``, ``decode_step``
and ``_slot_write`` as plain functions of ``(cfg, params, ...)``: the
layer loop is a Python loop over the stacked params' leading axis (the
reference scans it), and the cache slot write happens once after it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import _util
from . import attention, blocks, layers

__all__ = [
    "param_shapes",
    "init_params",
    "cache_len",
    "init_decode_state",
    "decode_step",
    "decode_front",
    "decode_tail",
]


def _check_family(cfg) -> None:
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode state")
    if cfg.family != "dense" or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            f"{' with MLA' if cfg.mla else ''} is not ported yet"
        )


def param_shapes(cfg) -> Dict[str, Any]:
    """The dense family's param tree as shapes, in the reference's layout
    (stacked layers on the leading axis, ``{"w": (d_in, d_out)}``)."""
    _check_family(cfg)
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def dense(d_in, d_out, bias=False):
        p = {"w": (L, d_in, d_out)}
        if bias:
            p["b"] = (L, d_out)
        return p

    def norm(stacked=True):
        lead = (L,) if stacked else ()
        p = {"g": lead + (d,)}
        if cfg.norm == "layernorm":
            p["b"] = lead + (d,)
        return p

    ff = cfg.d_ff
    if cfg.mlp == "gelu":
        mlp = {"w_in": (L, d, ff), "b_in": (L, ff), "w_out": (L, ff, d), "b_out": (L, d)}
    else:
        mlp = {"w_gate": (L, d, ff), "w_up": (L, d, ff), "w_down": (L, ff, d)}
    shapes: Dict[str, Any] = {
        "embed": {"table": (cfg.vocab_size, d)},
        "layers": {
            "attn_norm": norm(),
            "attn": {
                "wq": dense(d, qd, cfg.qkv_bias),
                "wk": dense(d, kvd, cfg.qkv_bias),
                "wv": dense(d, kvd, cfg.qkv_bias),
                "wo": dense(qd, d),
            },
            "mlp_norm": norm(),
            "mlp": mlp,
        },
        "final_norm": norm(stacked=False),
    }
    if cfg.pos_embedding == "learned":
        shapes["pos"] = {"table": (cfg.max_position, d)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = {"table": (cfg.vocab_size, d)}
    return shapes


def init_params(cfg, seed: int = 0, *, device: Any = "cuda") -> Dict[str, Any]:
    """Random bf16 params in :func:`param_shapes`' tree: every leaf
    ``standard_normal * 0.02``, drawn on ``device`` by a generator seeded
    with ``seed``, leaf by leaf in sorted-key order.  For serving without a
    checkpoint; the draw differs from the reference's ``Model.init``."""
    dev = _util.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(node):
        if isinstance(node, dict):               # shape tuples are the leaves
            return {k: draw(node[k]) for k in sorted(node)}
        x = torch.randn(node, generator=gen, dtype=torch.float32, device=dev)
        return (x * 0.02).to(cfg.dtype)

    return draw(param_shapes(cfg))


def cache_len(cfg, seq_len: int) -> int:
    if cfg.window:
        return min(seq_len, cfg.window)
    return seq_len


def init_decode_state(
    cfg, batch: int, seq_len: int, start_pos: Optional[int] = None,
    *, device: Any = "cuda",
) -> Dict[str, Any]:
    """Decode state with a cache sized for ``seq_len``.

    ``start_pos`` defaults to ``seq_len`` (a full context already
    processed); pass 0 to generate from scratch.
    """
    _check_family(cfg)
    dev = _util.resolve_device(device)
    L = cache_len(cfg, seq_len)
    sp = seq_len if start_pos is None else start_pos
    kv = attention.init_kv_cache(cfg, batch, L, cfg.n_layers, dev)
    return {
        "pos": torch.tensor(sp, dtype=torch.int32, device=dev),
        "kv_k": kv.k,
        "kv_v": kv.v,
    }


def decode_front(cfg, params, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Embed (+ learned positions): the step's work before the layers."""
    x = layers.embed(params["embed"], tokens)
    if cfg.pos_embedding == "learned":
        row = torch.clamp(pos, max=cfg.max_position - 1).to(torch.int64)
        pe = params["pos"]["table"].index_select(0, row.reshape(1))
        x = x + pe[None].to(x.dtype)
    return x


def decode_tail(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + unembed: the step's work after the layers."""
    x = blocks.norm_apply(cfg, params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return layers.unembed(head, x)


def decode_step(
    cfg, params, state: Dict[str, Any], tokens: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence. tokens: (B, 1) int32 → f32 logits."""
    _check_family(cfg)
    pos = state["pos"]
    x = decode_front(cfg, params, tokens, pos)
    c0, c1 = state["kv_k"], state["kv_v"]
    slot = pos % c0.shape[2]
    stack = params["layers"]
    outs0, outs1 = [], []
    for i in range(cfg.n_layers):
        lp = _util.tree_map(lambda a, i=i: a[i], stack)
        x, (u0, u1) = blocks.dense_block_decode(lp, x, (c0[i], c1[i]), pos, cfg)
        outs0.append(u0)
        outs1.append(u1)
    new_state = dict(state)
    new_state["kv_k"] = _slot_write(c0, torch.stack(outs0), slot)
    new_state["kv_v"] = _slot_write(c1, torch.stack(outs1), slot)
    new_state["pos"] = pos + 1
    return decode_tail(cfg, params, x), new_state


def _slot_write(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                axis: int = 2) -> torch.Tensor:
    """Write the new-token entries at ``slot`` along the cache-length axis
    as a masked select (a new tensor; the input cache is not modified)."""
    shape = [1] * cache.dim()
    shape[axis] = cache.shape[axis]
    idx = torch.arange(cache.shape[axis], device=cache.device).reshape(shape)
    return torch.where(idx == slot, new.to(cache.dtype), cache)
