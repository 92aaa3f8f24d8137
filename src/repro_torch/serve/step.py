"""Serving: the plain decode step, the compressed-resident ring, greedy
generation.

:func:`make_compressed_serve_step` reproduces ``decode_step`` outside its
layer loop: the same front (embed), the same block function per layer,
the same single cache write after the loop and the same tail (final norm
+ unembed), on the same stream — so its logits are bit-identical to
:func:`repro_torch.models.decode_step` over the uncompressed params.
Only where each layer's weights come from differs: the store decodes them
just ahead of compute.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, List, Optional, Tuple

import torch

from .. import _util
from ..models import blocks
from ..models.model import decode_front, decode_step, decode_tail, _slot_write

__all__ = ["make_serve_step", "make_compressed_serve_step", "greedy_generate"]


def make_serve_step(cfg) -> Callable:
    """serve_step(params, state, tokens) → (logits, state)."""

    def serve_step(params, state, tokens):
        return decode_step(cfg, params, state, tokens)

    return serve_step


def _layer_plan(cfg) -> List[Tuple[str, int]]:
    """[(stack_key, layer_index)] in decode order (dense family)."""
    return [("layers", i) for i in range(cfg.n_layers)]


def make_compressed_serve_step(cfg, store, *, ring: int = 2, prefetch: bool = True) -> Callable:
    """Compressed-resident decode step over a ``CompressedParamStore``.

    ``serve_step(state, tokens) -> (logits, new_state)`` — the contract of
    :func:`make_serve_step`'s step, but the stacked weights live in
    ``store`` as ZNN1 payloads and decode just ahead of compute.  With
    ``prefetch`` the step keeps ``ring - 1`` layers of decode in flight
    ahead of the layer being computed, so at most ``ring`` decoded layers
    are claimed at any moment (``store.peak_resident``).

    On a CUDA store, decodes run on a side stream: layer *i+1*'s K1/K2
    launches are enqueued there before layer *i*'s compute is enqueued on
    the current stream, an event orders each layer's compute after its
    decode, and ``record_stream`` keeps the decoded buffers alive until
    that compute is done.  On the CPU the same schedule runs in order.
    ``prefetch=False`` decodes each layer on demand (residency 1).
    """
    if cfg.family != "dense" or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family is ported to the ring"
        )
    if ring < 1:
        raise ValueError(f"ring must be >= 1, got {ring}")
    plan = _layer_plan(cfg)
    if store.n_layers("layers") != len(plan):
        raise ValueError(
            f"store stack 'layers' holds {store.n_layers('layers')} layers, "
            f"model {cfg.name} needs {len(plan)}"
        )
    dev = store.device
    depth = ring - 1 if prefetch else 0
    side = torch.cuda.Stream(dev) if (dev.type == "cuda" and depth) else None

    def _decode(j: int):
        key, i = plan[j]
        if side is None:
            return store.decode_layer(key, i), None
        with torch.cuda.stream(side):
            tree = store.decode_layer(key, i)
            done = torch.cuda.Event()
            done.record(side)
        return tree, done

    def _take(job):
        tree, done = job
        if done is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(done)
            for t in _util.tree_leaves(tree):
                t.record_stream(cur)
        return tree

    def serve_step(state, tokens):
        pos = state["pos"]
        x = decode_front(cfg, store.static, tokens, pos)
        c0, c1 = state["kv_k"], state["kv_v"]
        slot = pos % c0.shape[2]
        inflight: deque = deque()
        nxt = 0

        def pump() -> None:
            nonlocal nxt
            while nxt < len(plan) and len(inflight) < depth:
                inflight.append(_decode(nxt))
                nxt += 1

        pump()
        outs0, outs1 = [], []
        for j, (key, i) in enumerate(plan):
            if inflight:
                job = inflight.popleft()
            else:
                job = _decode(j)
                nxt = j + 1
            pump()                 # next layers' decode goes ahead of this compute
            lp = _take(job)
            x, (u0, u1) = blocks.dense_block_decode(lp, x, (c0[j], c1[j]), pos, cfg)
            store.release(key, i)
            outs0.append(u0)
            outs1.append(u1)
        new_state = dict(state)
        new_state["kv_k"] = _slot_write(c0, torch.stack(outs0), slot)
        new_state["kv_v"] = _slot_write(c1, torch.stack(outs1), slot)
        new_state["pos"] = pos + 1
        return decode_tail(cfg, store.static, x), new_state

    return serve_step


def greedy_generate(
    cfg,
    params,
    prompt: torch.Tensor,
    steps: int,
    *,
    serve_step: Optional[Callable] = None,
    logits_out: Optional[list] = None,
) -> Tuple[torch.Tensor, Any]:
    """Feed ``prompt`` (B, S) token by token through a decode step, then
    sample ``steps`` greedy tokens; returns ``(tokens (B, steps), state)``.

    ``serve_step(state, tokens) -> (logits, state)`` defaults to
    :func:`~repro_torch.models.decode_step` over ``params``; pass a
    :func:`make_compressed_serve_step` step to serve from a store.  When
    ``logits_out`` is a list, every step's logits are appended to it.
    Caches are sized for ``S + steps`` on the prompt's device.
    """
    from ..models.model import init_decode_state

    if prompt.dim() != 2:
        raise ValueError(
            f"prompt must be a (B, S) token tensor, got shape {tuple(prompt.shape)}"
        )
    B, S = prompt.shape
    if S == 0:
        raise ValueError(
            "prompt must contain at least one token (S == 0): the first "
            "sampled token is argmax over the prompt's last logits"
        )
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if serve_step is None:
        def serve_step(state, tokens):
            return decode_step(cfg, params, state, tokens)

    state = init_decode_state(cfg, B, S + steps, start_pos=0, device=prompt.device)
    logits = None
    for t in range(S):
        logits, state = serve_step(state, prompt[:, t : t + 1])
        if logits_out is not None:
            logits_out.append(logits)
    if steps == 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=prompt.device), state
    out = []
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    for _ in range(steps):
        out.append(tok)
        logits, state = serve_step(state, tok)
        if logits_out is not None:
            logits_out.append(logits)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    return torch.cat(out, dim=1), state
