"""The full-sequence forward and training loss, the decode state and the
one-token decode step for the dense, MoE, SSM, hybrid, vlm and audio
families.

A port of ``repro.models.model``'s ``forward`` / ``loss`` / ``_trunk`` /
``_scan_stack`` / ``_remat`` / ``_hybrid_forward``, ``init_decode_state``,
``decode_step`` and ``_slot_write`` as plain functions of ``(cfg, params,
...)``.  The forward runs each stack's ``*_block_train`` over the stacked
params' leading axis (split once by ``unbind``) and sums the blocks' aux
losses; ``cfg.remat`` maps to activation checkpointing around each layer
where autograd records.  The reference's sharding constraints
(``lshard``) stand where it has them: the residual after the embedding
and, sequence-parallel (``cfg.sp``), after each layer; the logits over
the vocab; the decode's embedded token.  On DTensors over a mesh
(``launch/dryrun.py``) they lay the activations out; on plain tensors
they return their input itself, so results off a mesh are bit-identical.
:func:`param_specs` gives the params' sharding specs
(``repro_torch.distributed.sharding``), as the reference's
``Model.param_specs``.  In decode the
layer loop is a Python loop over the stacked params' leading axis (the
reference scans it) — ``dense_layers`` then ``moe_layers`` for the MoE
family — and the cache slot write happens once after it, for all layers.
The SSM family's layers return their new recurrent state and conv
history, which stack into the new state.  The hybrid family runs each of
its ``mamba_groups`` and then the one ``shared_attn`` block with that
group's KV cache, then the ``mamba_tail``; the KV slot write happens once
after the groups, as in the reference's scanned step.  The vlm family is
the dense decoder behind a vision front end (``frontend_proj`` of
precomputed patch embeddings, M-RoPE over ``pos_thw`` in the forward; its
decode is the dense decode); the audio family is an encoder-only dense
stack behind an audio front end, with a forward and no decode.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import _util, trace
from ..distributed.sharding import gather_axis, lshard, param_pspecs
from . import attention, blocks, layers, ssm

__all__ = [
    "block_fn",
    "layer_plan",
    "cache_keys",
    "hybrid_groups",
    "write_caches",
    "param_shapes",
    "param_dtypes",
    "param_specs",
    "count_params_analytic",
    "init_params",
    "reference_norms",
    "cache_len",
    "init_decode_state",
    "forward",
    "loss",
    "decode_step",
    "decode_front",
    "decode_tail",
]


def block_fn(kind: str) -> Callable:
    """The block function of a layer kind, shared by every layer of a
    stack (looked up at each call, so a patched ``blocks`` function is
    the one that runs)."""
    return {"dense": blocks.dense_block_decode, "moe": blocks.moe_block_decode,
            "ssm": blocks.mamba_block_decode}[kind]


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


def _check_decode(cfg) -> None:
    """The decode entry points' check: an encoder-only config has no
    decode state (the reference's ``init_decode_state`` refusal)."""
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode state")
    _check_family(cfg)


def layer_plan(cfg) -> List[Tuple[str, int, str]]:
    """[(stack_key, layer_index, block_kind)] in decode order, for the
    families whose layers are one stack each after another (the hybrid
    family's shared block repeats across groups: it has no such plan).
    The vlm family's layers are dense; an encoder-only config raises."""
    _check_decode(cfg)
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the hybrid family's shared attention block repeats "
            "across groups, so it has no per-layer plan"
        )
    if cfg.family == "moe":
        fk = cfg.first_k_dense
        return [("dense_layers", i, "dense") for i in range(fk)] + [
            ("moe_layers", i, "moe") for i in range(cfg.n_layers - fk)
        ]
    kind = "ssm" if cfg.family == "ssm" else "dense"
    return [("layers", i, kind) for i in range(cfg.n_layers)]


def cache_keys(cfg) -> Tuple[str, str]:
    """The decode state's two stacked per-layer caches, in block-call
    order: the SSM family's recurrent state and conv history, else the
    attention caches."""
    if cfg.family == "ssm":
        return ("ssm_state", "ssm_conv")
    return ("mla_ckv", "mla_kr") if cfg.mla else ("kv_k", "kv_v")


def hybrid_groups(cfg) -> Tuple[int, int, int]:
    """(groups, Mamba2 layers a group, tail layers) of the hybrid family."""
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    return n_groups, every, cfg.n_layers - n_groups * every


def param_shapes(cfg) -> Dict[str, Any]:
    """The param tree as shapes, in the reference's layout (stacked
    layers on the leading axis, ``{"w": (d_in, d_out)}``): ``layers`` for
    the dense and SSM families, ``dense_layers`` (``first_k_dense`` of
    them, MLP width ``dense_d_ff``) and ``moe_layers`` for the MoE family,
    ``mamba_groups`` (leading axes: group, layer of the group),
    ``shared_attn`` (one dense block) and ``mamba_tail`` (when
    ``n_layers`` is not a whole number of groups) for the hybrid family;
    the vlm and audio families are a dense ``layers`` stack behind
    ``frontend_proj`` (``{"w": (frontend_dim, d_model)}``, no bias).
    Every family and any ``encoder_only`` draw, as the reference's
    ``Model.init`` does."""
    _check_family(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def norm(lead, width=d):
        p = {"g": lead + (width,)}
        if cfg.norm == "layernorm":
            p["b"] = lead + (width,)
        return p

    def dense(lead, d_in, d_out, bias=False):
        p = {"w": lead + (d_in, d_out)}
        if bias:
            p["b"] = lead + (d_out,)
        return p

    def attn(lead):
        if not cfg.mla:
            return {
                "wq": dense(lead, d, qd, cfg.qkv_bias),
                "wk": dense(lead, d, kvd, cfg.qkv_bias),
                "wv": dense(lead, d, kvd, cfg.qkv_bias),
                "wo": dense(lead, qd, d),
            }
        H, r = cfg.n_heads, cfg.kv_lora_rank
        return {
            "w_dq": dense(lead, d, cfg.q_lora_rank),
            "q_norm": {"g": lead + (cfg.q_lora_rank,)},
            "w_uq": dense(lead, cfg.q_lora_rank, H * (cfg.qk_nope_dim + cfg.qk_rope_dim)),
            "w_dkv": dense(lead, d, r),
            "kv_norm": {"g": lead + (r,)},
            "w_uk": dense(lead, r, H * cfg.qk_nope_dim),
            "w_uv": dense(lead, r, H * cfg.v_head_dim),
            "w_kr": dense(lead, d, cfg.qk_rope_dim),
            "wo": dense(lead, H * cfg.v_head_dim, d),
        }

    def swiglu(lead, ff):
        return {"w_gate": lead + (d, ff), "w_up": lead + (d, ff), "w_down": lead + (ff, d)}

    def mlp(lead, ff):
        if cfg.mlp == "gelu":
            return {"w_in": lead + (d, ff), "b_in": lead + (ff,),
                    "w_out": lead + (ff, d), "b_out": lead + (d,)}
        return swiglu(lead, ff)

    def mamba(lead):
        d_inner, H, N, conv_dim = ssm._dims(cfg)
        return {"norm": norm(lead), "mamba": {
            "in_proj": dense(lead, d, 2 * d_inner + 2 * N + H),
            "conv": {"w": lead + (cfg.ssm_conv, conv_dim), "b": lead + (conv_dim,)},
            "ssm": {"A_log": lead + (H,), "D": lead + (H,), "dt_bias": lead + (H,)},
            "norm": {"g": lead + (d_inner,)},
            "out_proj": dense(lead, d_inner, d),
        }}

    def block(lead, ff=None):
        p = {"attn_norm": norm(lead), "attn": attn(lead), "mlp_norm": norm(lead)}
        if ff is not None:
            p["mlp"] = mlp(lead, ff)
            return p
        E, f = cfg.n_experts, cfg.moe_d_ff
        p["moe"] = {
            "router": {"w": lead + (d, E)},
            "experts": swiglu(lead + (E,), f),
        }
        if cfg.n_shared_experts:
            p["moe"]["shared"] = swiglu(lead, f * cfg.n_shared_experts)
        return p

    shapes: Dict[str, Any] = {"embed": {"table": (cfg.vocab_size, d)}}
    if cfg.pos_embedding == "learned":
        shapes["pos"] = {"table": (cfg.max_position, d)}
    if cfg.frontend != "none":
        shapes["frontend_proj"] = dense((), cfg.frontend_dim, d)
    if cfg.family == "moe":
        fk = cfg.first_k_dense
        if fk:
            shapes["dense_layers"] = block((fk,), cfg.dense_d_ff)
        shapes["moe_layers"] = block((cfg.n_layers - fk,))
    elif cfg.family == "ssm":
        shapes["layers"] = mamba((cfg.n_layers,))
    elif cfg.family == "hybrid":
        n_groups, every, tail = hybrid_groups(cfg)
        shapes["mamba_groups"] = mamba((n_groups, every))
        shapes["shared_attn"] = block((), cfg.d_ff)
        if tail:
            shapes["mamba_tail"] = mamba((tail,))
    else:
        shapes["layers"] = block((cfg.n_layers,), cfg.d_ff)
    shapes["final_norm"] = norm(())
    if not cfg.tie_embeddings:
        shapes["lm_head"] = {"table": (cfg.vocab_size, d)}
    return shapes


def param_dtypes(cfg) -> Dict[str, Any]:
    """:func:`param_shapes`' tree with each leaf's dtype: ``cfg.dtype``,
    but f32 for the MoE routers and the Mamba2 ``ssm`` leaves (``A_log``,
    ``D``, ``dt_bias``), as the reference's ``init_moe`` and
    ``init_mamba2`` make them."""

    def walk(node, path):
        if isinstance(node, dict):               # shape tuples are the leaves
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        f32 = path[-2:] == ("router", "w") or path[-2:-1] == ("ssm",)
        return torch.float32 if f32 else cfg.dtype

    return walk(param_shapes(cfg), ())


def param_specs(cfg, mesh=None) -> Dict[str, Any]:
    """:func:`param_shapes`' tree with each leaf's
    :class:`~repro_torch.distributed.sharding.PartitionSpec` under the name
    rules, ZeRO-3 as ``cfg.zero3`` says: the reference's
    ``Model.param_specs(mesh)``.  It reads shapes only."""
    return param_pspecs(param_shapes(cfg), zero3=cfg.zero3, mesh=mesh)


def count_params_analytic(cfg, active_only: bool = False) -> int:
    """The parameter count of :func:`param_shapes`' tree, the reference's
    ``count_params_analytic``: with ``active_only`` each leaf under
    ``experts/`` counts ``experts_per_token / n_experts`` of its size
    (integer division a leaf, as the reference's)."""

    def walk(node, path):
        if isinstance(node, dict):               # shape tuples are the leaves
            return sum(walk(v, path + k + "/") for k, v in node.items())
        n = math.prod(node)
        if active_only and "experts/" in path and cfg.n_experts:
            n = n * cfg.experts_per_token // cfg.n_experts
        return n

    return walk(param_shapes(cfg), "")


def init_params(cfg, seed: int = 0, *, device: Any = "cuda") -> Dict[str, Any]:
    """Random params in :func:`param_shapes`' tree: every leaf
    ``standard_normal * 0.02`` in its :func:`param_dtypes` dtype (bf16;
    the MoE routers and the Mamba2 ``ssm`` leaves f32), drawn on ``device`` by a generator seeded with
    ``seed``, leaf by leaf in sorted-key order.  For serving without a
    checkpoint; the draw differs from the reference's ``Model.init``."""
    dev = _util.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(node, dt):
        if isinstance(node, dict):               # shape tuples are the leaves
            return {k: draw(node[k], dt[k]) for k in sorted(node)}
        x = torch.randn(node, generator=gen, dtype=torch.float32, device=dev)
        return (x * 0.02).to(dt)

    return draw(param_shapes(cfg), param_dtypes(cfg))


def reference_norms(params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` with every norm's gain 1 and every layernorm bias 0, as
    the reference's ``Model.init`` sets them (``layers.init_rmsnorm`` /
    ``init_layernorm``); every other leaf is shared, not copied.

    :func:`init_params` draws the gains at ``0.02 * N(0, 1)`` like every
    other leaf, so each norm scales its block's input by about 0.02 and the
    blocks move the logits by less than 1e-3 of the largest: a comparison
    of logits on such params cannot see the blocks.  On these it can.
    """

    def walk(node, in_norm):
        if not isinstance(node, dict):
            return node
        if in_norm:
            return {k: (torch.ones_like(v) if k == "g" else torch.zeros_like(v))
                    if k in ("g", "b") else v for k, v in node.items()}
        return {k: walk(v, k.endswith("norm")) for k, v in node.items()}

    return walk(params, False)


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
    processed); pass 0 to generate from scratch.  The vlm family's state
    is the dense one; an encoder-only config raises ``ValueError``.
    """
    _check_decode(cfg)
    dev = _util.resolve_device(device)
    L = cache_len(cfg, seq_len)
    sp = seq_len if start_pos is None else start_pos
    state = {"pos": torch.tensor(sp, dtype=torch.int32, device=dev)}
    if cfg.family == "ssm":
        sc = ssm.init_ssm_cache(cfg, batch, cfg.n_layers, dev)
        state.update({"ssm_state": sc.state, "ssm_conv": sc.conv})
    elif cfg.family == "hybrid":
        n_groups, every, tail = hybrid_groups(cfg)
        sc = ssm.init_ssm_cache(cfg, batch, n_groups * every, dev)
        state.update({"ssm_state": sc.state.reshape(n_groups, every, *sc.state.shape[1:]),
                      "ssm_conv": sc.conv.reshape(n_groups, every, *sc.conv.shape[1:])})
        if tail:
            tc = ssm.init_ssm_cache(cfg, batch, tail, dev)
            state.update({"ssm_state_tail": tc.state, "ssm_conv_tail": tc.conv})
        kv = attention.init_kv_cache(cfg, batch, L, n_groups, dev)
        state.update({"kv_k": kv.k, "kv_v": kv.v})
    elif cfg.mla:
        c = attention.init_mla_cache(cfg, batch, L, cfg.n_layers, dev)
        state.update({"mla_ckv": c["c_kv"], "mla_kr": c["k_rope"]})
    else:
        kv = attention.init_kv_cache(cfg, batch, L, cfg.n_layers, dev)
        state.update({"kv_k": kv.k, "kv_v": kv.v})
    return state


def _check_one_device(params, batch: Dict[str, torch.Tensor]) -> None:
    """Raise unless every param leaf and batch tensor is on one device."""
    devs = {t.device for t in _util.tree_leaves(params)} | {t.device for t in batch.values()}
    if len(devs) != 1:
        raise ValueError(f"params and batch lie on more than one device: {sorted(map(str, devs))}")


def _remat(cfg, fn: Callable) -> Callable:
    """The reference's ``Model._remat`` around one layer's function, where
    autograd records: ``"full"`` recomputes the layer in the backward
    (``torch.utils.checkpoint``), ``"dots"`` saves the outputs of the
    layer's products without batch dimensions and recomputes the rest (a
    selective checkpoint policy, :func:`_save_dots`: the reference's
    ``dots_with_no_batch_dims_saveable``), ``"none"`` saves
    everything.  It changes memory, never values."""
    if cfg.remat not in ("full", "dots") or not torch.is_grad_enabled():
        return fn
    from torch.utils import checkpoint as ckpt

    kwargs = {"use_reentrant": False}
    if cfg.remat == "dots":
        kwargs["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: ckpt.checkpoint(fn, *args, **kwargs)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpoint policy: keep the outputs of products without
    batch dimensions (the projections' ``mm``), recompute the rest.  Ops
    run under ``no_grad`` (the custom backward passes' forwards: the flash
    loop's score blocks) are never kept, as the policy sees every op."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _DOT_OPS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))


def _unstack(stack) -> List[Any]:
    """A stacked param tree as one tree a layer, split once per leaf by
    ``unbind`` (under autograd one stack of the layers' gradients, where
    indexing each layer would add a zero tensor of the whole stack per
    layer)."""
    leaves, treedef = _util.tree_flatten(stack)
    parts = [t.unbind(0) for t in leaves]
    return [_util.tree_unflatten(treedef, [p[i] for p in parts]) for i in range(len(parts[0]))]


def _sp_shard(cfg, x: torch.Tensor) -> torch.Tensor:
    """The sequence-parallel residual constraint: each layer's output
    sharded (batch, seq) over (data, model) where ``cfg.sp``, else the
    carry's layout (:func:`_carry`)."""
    if cfg.sp:
        return lshard(x, "batch", "seq_sp", None)
    return _carry(x)


def _carry(x: torch.Tensor) -> torch.Tensor:
    """The residual carried from one layer to the next, laid out by batch:
    the one layout the reference's scanned carry keeps across layers (so
    every layer meets the input the first one does)."""
    return lshard(x, "batch", None, None)


def _whole_seq(x: torch.Tensor) -> torch.Tensor:
    """A sequence-parallel carry gathered over 'model' where a layer (or
    the head) first uses it, as GSPMD gathers it for the reference: the
    products then see (batch, seq) cut over one mesh axis only."""
    return gather_axis(x, "model")


def _scan_stack(stack, x: torch.Tensor, apply_fn, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_fn(layer_params, x) -> (x, aux)`` over the stack's leading
    axis in order, each layer under ``cfg.remat`` with its output under
    :func:`_sp_shard`; the aux losses summed in f32."""

    def apply_sp(lp, h):
        h, a = apply_fn(lp, _whole_seq(h))
        return _sp_shard(cfg, h), a

    fn = _remat(cfg, apply_sp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unstack(stack):
        x, a = fn(lp, x)
        aux = aux + a
    return x, aux


def forward(cfg, params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: the batch → (f32 logits (B, S, vocab), aux
    loss f32 scalar).

    The batch is ``{"tokens": (B, S) int32}``; for the vlm family
    ``{"patches": (B, S_img, frontend_dim), "tokens": (B, S_txt),
    "pos_thw": (B, S_img + S_txt, 3)}`` (S = S_img + S_txt rows, the
    patches first); for the audio family ``{"frames": (B, S,
    frontend_dim)}``; other keys (``labels``) are not read.  Runs on the
    device of its params; params and batch on more than one device raise.
    """
    _check_family(cfg)
    _check_one_device(params, batch)
    x, aux = _trunk(cfg, params, batch)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return lshard(layers.unembed(head, _whole_seq(x)), "batch", None, "vocab"), aux


def _trunk(cfg, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Everything up to and including the final norm: (x, aux).  The vlm
    front end projects the patches (bf16) ahead of the token embeddings
    and hands ``pos_thw`` to every dense block (M-RoPE); the audio front
    end projects the frames."""
    pos_thw = None
    if cfg.family == "vlm":
        img = lshard(layers.dense(params["frontend_proj"], batch["patches"]), "batch", None, None)
        txt = lshard(layers.embed(params["embed"], batch["tokens"]), "batch", None, None)
        x = torch.cat([img.to(torch.bfloat16), txt], dim=1)
        pos_thw = batch["pos_thw"]
    elif cfg.family == "audio":
        x = layers.dense(params["frontend_proj"], batch["frames"])
    else:
        x = layers.embed(params["embed"], batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    if cfg.pos_embedding == "learned":
        x = x + params["pos"]["table"][:S][None].to(x.dtype)
    x = lshard(x, "batch", None, None)
    if cfg.family in ("dense", "vlm", "audio"):
        x, aux = _scan_stack(params["layers"], x, lambda lp, h: blocks.dense_block_train(
            lp, h, cfg, positions, pos_thw), cfg)
    elif cfg.family == "moe":
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if "dense_layers" in params:
            x, a = _scan_stack(params["dense_layers"], x, lambda lp, h: blocks.dense_block_train(
                lp, h, cfg, positions), cfg)
            aux = aux + a
        x, a = _scan_stack(params["moe_layers"], x, lambda lp, h: blocks.moe_block_train(
            lp, h, cfg, positions), cfg)
        aux = aux + a
    elif cfg.family == "ssm":
        x, aux = _scan_stack(params["layers"], x, lambda lp, h: blocks.mamba_block_train(
            lp, h, cfg), cfg)
    else:
        x, aux = _hybrid_forward(cfg, params, x, positions)
    return blocks.norm_apply(cfg, params["final_norm"], x), aux


def _hybrid_forward(cfg, params, x: torch.Tensor, positions: torch.Tensor):
    """Each of ``mamba_groups``' groups of Mamba2 layers, then the one
    ``shared_attn`` dense block (with the config's window) at
    ``positions``; then the ``mamba_tail``.  aux is 0."""
    shared = params["shared_attn"]

    def mamba(lp, h):
        return blocks.mamba_block_train(lp, h, cfg)

    attend = _remat(cfg, lambda h: blocks.dense_block_train(shared, _whole_seq(h), cfg, positions))
    for group in _unstack(params["mamba_groups"]):
        x, _ = _scan_stack(group, x, mamba, cfg)
        x, _ = attend(x)
        x = _sp_shard(cfg, x)
    if "mamba_tail" in params:
        x, _ = _scan_stack(params["mamba_tail"], x, mamba, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss(cfg, params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss, the reference's ``Model.loss``: ``(total, {"ce",
    "aux"})`` with ``total = ce + aux_loss_coef * aux`` (f32).

    The vlm family takes its text logits ``[:, s_img - 1 : s_img - 1 +
    s_txt]`` from the full forward and applies :func:`layers.cross_entropy`;
    every other family runs the trunk and :func:`layers.fused_cross_entropy`
    on the head (``ce_chunks`` chunks; mask ones where the batch has none),
    so the (B, S, V) logits never exist whole.  ``batch`` holds ``labels``
    (and optionally ``mask``) beside the forward's keys.
    """
    _check_family(cfg)
    _check_one_device(params, batch)
    if cfg.family == "vlm":
        logits, aux = forward(cfg, params, batch)
        s_img, s_txt = batch["patches"].shape[1], batch["tokens"].shape[1]
        ce = layers.cross_entropy(logits[:, s_img - 1: s_img - 1 + s_txt], batch["labels"],
                                  batch.get("mask"))
    else:
        x, aux = _trunk(cfg, params, batch)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        labels = batch["labels"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(labels, dtype=torch.float32)
        ce = layers.fused_cross_entropy(head["table"], x, labels, mask, cfg.ce_chunks)
    return ce + cfg.aux_loss_coef * aux, {"ce": ce, "aux": aux}


def decode_front(cfg, params, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Embed (+ learned positions), laid out by batch: the step's work
    before the layers (the reference's ``decode_step`` and its serve
    step's ``_decode_front``, one function here)."""
    with trace.span("model.front"):
        x = layers.embed(params["embed"], tokens)
        if cfg.pos_embedding == "learned":
            row = torch.clamp(pos, max=cfg.max_position - 1).to(torch.int64)
            pe = params["pos"]["table"].index_select(0, row.reshape(1))
            x = x + pe[None].to(x.dtype)
        return lshard(x, "batch", None, None)


def decode_tail(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + unembed: the step's work after the layers."""
    with trace.span("model.tail"):
        x = blocks.norm_apply(cfg, params["final_norm"], x)
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        return layers.unembed(head, x)


def decode_step(
    cfg, params, state: Dict[str, Any], tokens: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence. tokens: (B, 1) int32 → f32 logits."""
    if cfg.family == "hybrid":
        return _hybrid_decode_step(cfg, params, state, tokens)
    plan = layer_plan(cfg)
    pos = state["pos"]
    x = decode_front(cfg, params, tokens, pos)
    k0, k1 = cache_keys(cfg)
    c0, c1 = state[k0], state[k1]
    outs0, outs1 = [], []
    for j, (key, i, kind) in enumerate(plan):
        lp = _util.tree_map(lambda a, i=i: a[i], params[key])
        x, (u0, u1) = block_fn(kind)(lp, x, (c0[j], c1[j]), pos, cfg)
        x = _carry(x)
        outs0.append(u0)
        outs1.append(u1)
    new_state = dict(state)
    new_state.update(write_caches(cfg, state, torch.stack(outs0), torch.stack(outs1)))
    new_state["pos"] = pos + 1
    return decode_tail(cfg, params, x), new_state


def write_caches(cfg, state: Dict[str, Any], n0: torch.Tensor,
                 n1: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The new stacked caches from every layer's outputs: an SSM layer's
    whole new state and conv history, or the new attention entries written
    at slot ``pos % cache length`` (the single write after the loop)."""
    k0, k1 = cache_keys(cfg)
    if cfg.family == "ssm":
        return {k0: n0, k1: n1}
    with trace.span("model.write_caches"):
        slot = state["pos"] % state[k0].shape[2]
        return {k0: _slot_write(state[k0], n0, slot), k1: _slot_write(state[k1], n1, slot)}


def _mamba_stack(cfg, stack, x, states, convs, pos):
    """The Mamba2 layers of one stack in order: (x, new states, new convs)."""
    outs_s, outs_c = [], []
    for i in range(states.shape[0]):
        lp = _util.tree_map(lambda a, i=i: a[i], stack)
        x, (st, cv) = blocks.mamba_block_decode(lp, x, (states[i], convs[i]), pos, cfg)
        x = _carry(x)
        outs_s.append(st)
        outs_c.append(cv)
    return x, torch.stack(outs_s), torch.stack(outs_c)


def _hybrid_decode_step(cfg, params, state, tokens):
    """The hybrid step (the reference's scanned form): each group's Mamba2
    layers, then the shared attention block over that group's KV cache;
    one slot write for all groups; then the tail's Mamba2 layers."""
    pos = state["pos"]
    x = decode_front(cfg, params, tokens, pos)
    shared = params["shared_attn"]
    kv_k, kv_v = state["kv_k"], state["kv_v"]
    ns, nc, nk, nv = [], [], [], []
    for g in range(state["ssm_state"].shape[0]):
        group = _util.tree_map(lambda a, g=g: a[g], params["mamba_groups"])
        x, st, cv = _mamba_stack(cfg, group, x, state["ssm_state"][g], state["ssm_conv"][g], pos)
        x, (kn, vn) = blocks.dense_block_decode(shared, x, (kv_k[g], kv_v[g]), pos, cfg)
        x = _carry(x)
        ns.append(st)
        nc.append(cv)
        nk.append(kn)
        nv.append(vn)
    slot = pos % kv_k.shape[2]
    new_state = dict(state)
    new_state.update({
        "ssm_state": torch.stack(ns), "ssm_conv": torch.stack(nc),
        "kv_k": _slot_write(kv_k, torch.stack(nk), slot),
        "kv_v": _slot_write(kv_v, torch.stack(nv), slot),
    })
    if "mamba_tail" in params:
        x, st, cv = _mamba_stack(cfg, params["mamba_tail"], x, state["ssm_state_tail"],
                                 state["ssm_conv_tail"], pos)
        new_state.update({"ssm_state_tail": st, "ssm_conv_tail": cv})
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
