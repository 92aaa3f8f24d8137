"""Serving: prefill, the plain decode step, the KV-tiered step, the
compressed-resident ring (whole layers or tiles, with or without the KV
tier), greedy generation.

:func:`make_compressed_serve_step` reproduces ``decode_step`` outside its
layer loop: the same front (embed), the same block function per layer,
the same single cache write after the loop and the same tail (final norm
+ unembed), on the same stream — so its logits are bit-identical to
:func:`repro_torch.models.decode_step` over the uncompressed params.
Only where each layer's weights come from differs: the store decodes them
just ahead of compute.

:func:`inference_param_specs` and :func:`decode_state_specs` are the
serving layouts on a mesh (``repro_torch.distributed.sharding`` specs):
attention and dense weights tensor-parallel over 'model' and replicated
over 'data'; experts E over 'data' × ff over 'model'; caches with the
batch over 'data' where it divides and, for 'model', kv heads when they
divide, else the cache length, else head_dim (MLA: the cache length, else
the latent); SSM states and conv histories by batch and heads.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import _util, trace
from ..distributed.sharding import P, map_with_path, mesh_axes_and_sizes
from ..models.model import (
    block_fn, cache_keys, decode_front, decode_step, decode_tail, forward, layer_plan,
    param_specs, write_caches,
)

__all__ = [
    "make_prefill",
    "make_serve_step",
    "make_kv_tiered_serve_step",
    "make_compressed_serve_step",
    "greedy_generate",
    "inference_param_specs",
    "decode_state_specs",
]


def make_prefill(cfg) -> Callable:
    """prefill(params, batch) → f32 logits (B, S, vocab) for the whole
    prompt ``batch["tokens"]`` (B, S) (vlm: the patches, tokens and
    ``pos_thw``; audio: the frames): one :func:`~repro_torch.models.
    forward` (blockwise attention, chunked SSD), on the params' device."""

    def prefill(params, batch):
        logits, _ = forward(cfg, params, batch)
        return logits

    return prefill


def _div(n: int, sizes: Dict[str, int], axis: str) -> bool:
    return axis in sizes and n % sizes[axis] == 0


def inference_param_specs(cfg, mesh) -> Any:
    """Serving-time param layout: ``model.param_specs`` with the ZeRO-3
    'data' axis stripped (per-layer all-gathers amortize over a training
    batch, not over a decoded token); expert leaves E over 'data' × ff
    over 'model', each where it divides, so expert weights never move."""
    sizes = mesh_axes_and_sizes(mesh)[1]

    def one(path, spec):                      # a param spec has an entry a dimension
        nd = len(spec)
        if "experts/" in path and cfg.n_experts:
            e_ax = "data" if _div(cfg.n_experts, sizes, "data") else None
            f_ax = "model" if _div(cfg.moe_d_ff, sizes, "model") else None
            pad = [None] * (nd - 3)
            if path.endswith("w_down"):
                return P(*(pad + [e_ax, f_ax, None]))
            return P(*(pad + [e_ax, None, f_ax]))
        # strip the zero3 ('data') axis everywhere else
        return P(*[None if ax == "data" else ax for ax in spec])

    return map_with_path(one, param_specs(cfg, mesh))


def decode_state_specs(cfg, state_tree, mesh) -> Any:
    """Specs of a decode state (it reads shapes only: a state made on
    ``device="meta"`` will do).  ``pos`` replicated; ``kv_*`` (L, B, Lc, G,
    hd): batch over 'data' where it divides, and 'model' on the kv heads
    when they divide, else on the cache length (length-sharded decode keeps
    the score product local), else on head_dim; ``mla_*`` (L, B, Lc, r):
    the cache length, else the latent; ``ssm_state`` (..., B, H, P, N) and
    ``ssm_conv`` (..., B, W, C) by batch and heads / channels."""
    sizes = mesh_axes_and_sizes(mesh)[1]

    def one(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if path.endswith("pos"):
            return P()
        if "kv_" in path:
            b = "data" if _div(shape[1], sizes, "data") else None
            if _div(shape[3], sizes, "model"):
                return P(None, b, None, "model", None)
            if _div(shape[2], sizes, "model"):
                return P(None, b, "model", None, None)
            hd = "model" if _div(shape[4], sizes, "model") else None
            return P(None, b, None, None, hd)
        if "mla_" in path:
            b = "data" if _div(shape[1], sizes, "data") else None
            if _div(shape[2], sizes, "model"):
                return P(None, b, "model", None)
            r = "model" if _div(shape[3], sizes, "model") else None
            return P(None, b, None, r)
        if "ssm_state" in path:
            b = "data" if _div(shape[-4], sizes, "data") else None
            h = "model" if _div(shape[-3], sizes, "model") else None
            return P(*([None] * (nd - 4) + [b, h, None, None]))
        if "ssm_conv" in path:
            b = "data" if _div(shape[-3], sizes, "data") else None
            c = "model" if _div(shape[-1], sizes, "model") else None
            return P(*([None] * (nd - 3) + [b, None, c]))
        return P(*([None] * nd))

    return map_with_path(one, state_tree)


def make_serve_step(cfg) -> Callable:
    """serve_step(params, state, tokens) → (logits, state)."""

    def serve_step(params, state, tokens):
        with trace.span("serve.step"):
            return decode_step(cfg, params, state, tokens)

    return serve_step


def _check_served(cfg) -> None:
    """The reference's rejection: an encoder-only family (audio) has no
    decode path.  The vlm family serves as the dense one."""
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} has no decode path")


def make_kv_tiered_serve_step(cfg, params, kv_store) -> Callable:
    """Decode step over a :class:`~repro_torch.serve.kvcache.KVCacheStore`.

    ``serve_step(tokens) -> logits``: the cache lives in ``kv_store`` (hot
    suffix + compressed cold blocks) instead of a state dict and advances
    as a side effect of the call.  Each layer's block function receives the
    store's full-length caches put back together (byte-identical to the
    untiered ones), and the new entries go through the same masked write,
    so the logits are bit-identical to :func:`~repro_torch.models.
    decode_step` over the untiered cache.

    ssm / hybrid models have no cache-length axis and are rejected, as the
    reference rejects them.
    """
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} has no attention-cache length axis to tier"
        )
    _check_served(cfg)
    if kv_store.n_layers != cfg.n_layers:
        raise ValueError(
            f"kv_store holds {kv_store.n_layers} layers, model {cfg.name} has {cfg.n_layers}"
        )
    plan = layer_plan(cfg)

    def serve_step(tokens):
        pos = torch.tensor(kv_store.pos, dtype=torch.int32, device=kv_store.device)
        x = decode_front(cfg, params, tokens, pos)
        outs0, outs1 = [], []
        for j, (key, i, kind) in enumerate(plan):
            lp = _util.tree_map(lambda a, i=i: a[i], params[key])
            x, (u0, u1) = block_fn(kind)(lp, x, kv_store.layer_caches(j), pos, cfg)
            outs0.append(u0)
            outs1.append(u1)
        kv_store.append(torch.stack(outs0), torch.stack(outs1))
        return decode_tail(cfg, params, x)

    serve_step.kv_store = kv_store
    return serve_step


def make_compressed_serve_step(
    cfg, store, *, ring: int = 2, prefetch: bool = True, tiles: int = 1, kv_store=None,
) -> Callable:
    """Compressed-resident decode step over a ``CompressedParamStore``.

    ``serve_step(state, tokens) -> (logits, new_state)`` — the contract of
    :func:`make_serve_step`'s step, but the stacked weights live in
    ``store`` as ZNN1 payloads and decode just ahead of compute.  With
    ``prefetch`` the step keeps ``ring - 1`` layers of decode in flight
    ahead of the layer being computed, so at most ``ring`` decoded layers
    are claimed at any moment (``store.peak_resident``).

    ``tiles`` sets the decode granularity: with ``tiles > 1`` each layer
    splits into ``tiles`` contiguous groups of leaves
    (``store.decode_layer_tile``) that decode as separate jobs, so a
    layer's first tiles are ready while its last are still decoding, and
    the next layers' tiles enter the decoder as the current layer's are
    taken.  Residency is then counted per tile slot: at most ``ring ×
    tiles``.  The layer put back together is leaf for leaf the same.

    ``kv_store`` (a :class:`~repro_torch.serve.kvcache.KVCacheStore`)
    joins the KV tier to the ring: the state then needs only ``pos``, each
    layer attends over the store's caches put back together, and the slot
    write after the loop becomes ``kv_store.append``.

    The SSM family runs the same ring: each layer takes its recurrent state
    and conv history from the state and returns new ones, which stack into
    the new state.  As in the reference, hybrid (mamba-group) models are
    rejected (their shared attention params repeat across groups), and an
    SSM state has no cache-length axis for the KV tier.

    On a CUDA store, decodes run on a side stream: the next jobs' K1/K2
    launches are enqueued there before a layer's compute is enqueued on
    the current stream, an event orders each layer's (or tile's) compute
    after its decode, and the decoded buffers stay referenced until an
    event after that compute has passed on the card; a new decode first
    waits until fewer than ``ring`` computed layers are held, so the host
    runs at most ``ring`` layers ahead of the card.  (With
    ``record_stream`` instead, the host enqueued step after step and the
    decoded layers of several steps stayed allocated at once: on an 80 GB
    H100, deepseek_v2_236b's 8.6 GB of layers a step ran the card out of
    memory.)  On the CPU the same schedule runs in order.
    ``prefetch=False`` decodes each job on demand.  Logits are
    bit-identical to :func:`repro_torch.models.decode_step`.
    """
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "hybrid (mamba-group) models are not supported by the "
            "compressed serving ring: shared_attn params repeat per group"
        )
    _check_served(cfg)
    if ring < 1:
        raise ValueError(f"ring must be >= 1, got {ring}")
    if tiles < 1:
        raise ValueError(f"tiles must be >= 1, got {tiles}")
    if kv_store is not None and cfg.family == "ssm":
        raise NotImplementedError(f"{cfg.name}: ssm state has no cache-length axis to tier")
    plan = layer_plan(cfg)
    for key in dict.fromkeys(k for k, _, _ in plan):
        want = sum(1 for k, _, _ in plan if k == key)
        if store.n_layers(key) != want:
            raise ValueError(
                f"store stack {key!r} holds {store.n_layers(key)} layers, "
                f"model {cfg.name} needs {want}"
            )
    if kv_store is not None and kv_store.n_layers != len(plan):
        raise ValueError(
            f"kv_store holds {kv_store.n_layers} layers, model {cfg.name} has {len(plan)}"
        )
    k0, k1 = cache_keys(cfg)
    dev = store.device
    # Ring depth in decode jobs: whole layers (tiles == 1) or tile slots;
    # either way ring - 1 layers' worth of decode ahead of compute.
    n_jobs = len(plan) * tiles
    depth = (ring - 1) * tiles if prefetch else 0
    side = torch.cuda.Stream(dev) if (dev.type == "cuda" and depth) else None
    # Decoded layers whose compute is enqueued, each with an event at its
    # end on the compute stream.  Their buffers (allocated on the side
    # stream) are dropped only once the card is past that event, and a new
    # decode first waits until fewer than ``ring`` of them are held.
    held: deque = deque()

    def _run(n: int):
        j, t = divmod(n, tiles)
        key, i, _ = plan[j]
        if tiles == 1:
            return store.decode_layer(key, i)
        return store.decode_layer_tile(key, i, t, tiles)

    def _decode(n: int):
        if side is None:
            with trace.span("ring.decode"):
                return _run(n), None
        with trace.span("ring.wait"):
            while held and (len(held) >= ring or held[0][0].query()):
                held.popleft()[0].synchronize()
        with trace.span("ring.decode"), torch.cuda.stream(side):
            out = _run(n)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def _take(job):
        out, ready = job
        if ready is not None:
            torch.cuda.current_stream(dev).wait_event(ready)
        return out

    def _release(key: str, i: int, lp) -> None:
        if tiles == 1:
            store.release(key, i)
        else:
            for t in range(tiles):
                store.release_tile(key, i, t, tiles)
        if side is not None:
            end = torch.cuda.Event()
            end.record(torch.cuda.current_stream(dev))
            held.append((end, lp))

    def _step(state, tokens):
        pos = state["pos"]
        x = decode_front(cfg, store.static, tokens, pos)
        inflight: deque = deque()
        nxt = 0

        def pump() -> None:
            nonlocal nxt
            while nxt < n_jobs and len(inflight) < depth:
                inflight.append(_decode(nxt))
                nxt += 1

        def next_job(n: int):
            nonlocal nxt
            if inflight:
                job = inflight.popleft()
            else:
                job = _decode(n)
                nxt = n + 1
            pump()                 # later jobs go ahead of this compute
            return _take(job)

        def layer_params(j: int):
            if tiles == 1:
                return next_job(j)
            # the layer's tiles in order, pump() between them so later
            # layers' tiles enter the decoder as slots free up
            arrays: Dict[int, Any] = {}
            for t in range(tiles):
                arrays.update(next_job(j * tiles + t))
            key, i, _ = plan[j]
            return store.layer_unflatten(key, i, [arrays[k] for k in sorted(arrays)])

        pump()
        if kv_store is None:
            c0, c1 = state[k0], state[k1]
        outs0, outs1 = [], []
        for j, (key, i, kind) in enumerate(plan):
            lp = layer_params(j)
            caches = (c0[j], c1[j]) if kv_store is None else kv_store.layer_caches(j)
            x, (u0, u1) = block_fn(kind)(lp, x, caches, pos, cfg)
            _release(key, i, lp)
            outs0.append(u0)
            outs1.append(u1)
        new_state = dict(state)
        n0, n1 = torch.stack(outs0), torch.stack(outs1)
        if kv_store is None:        # the single cache write, as decode_step
            new_state.update(write_caches(cfg, state, n0, n1))
        else:
            kv_store.append(n0, n1)
        new_state["pos"] = pos + 1
        return decode_tail(cfg, store.static, x), new_state

    def serve_step(state, tokens):
        with trace.span("serve.step"):
            return _step(state, tokens)

    serve_step.store = store
    serve_step.ring = ring
    serve_step.tiles = tiles
    serve_step.kv_store = kv_store
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
