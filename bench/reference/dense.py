"""Plain float32 reference of the dense decoder family (gpt_bigcode and
llama-style models), written from the published layer equations.

It imports ``torch`` alone and takes only what the benchmark hands it:
the configuration's numbers (the ``config`` object of its file), the
weights and the context the benchmark drew from the seed, and the tokens
of the requests it judges.  Every product and every elementwise step runs
in float32 with TF32 off; the caller sets that (``check.py``).

A request is a context of ``C`` cached positions (keys after RoPE, and
values, per layer and KV head) followed by ``S`` tokens at positions
``C .. C + S - 1``; :func:`logits` returns the logits at each of those
positions, every new token attending causally to the new tokens before it
and to the whole context.

Departure from the published models: gpt_bigcode's attention output
projection has a bias, and the program's layer has none.  The benchmark's
model is the program's layout, so its weights carry no such bias and this
reference adds none; every bias they do carry is drawn as the other
weights are, and applied here as published.

It also counts a decode step's model FLOPs (:func:`decode_flops`) from the
configuration's numbers, so that the count belongs to the family: another
family brings its own count in its own file.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

FP8_MAX = 448.0          # largest finite float8_e4m3fn


def param_shapes(conf: Dict[str, Any]) -> Dict[str, Any]:
    """The weights this reference reads, as shapes, in the serving layout:
    layers stacked on a leading axis, a product's weight as ``(d_in,
    d_out)``, embedding and head tables as ``(vocab, d_model)``."""
    L, d, hd = conf["n_layers"], conf["d_model"], conf["head_dim"]
    qd, kvd, ff = conf["n_heads"] * hd, conf["n_kv_heads"] * hd, conf["d_ff"]

    def norm(lead):
        p = {"g": lead + (d,)}
        if conf["norm"] == "layernorm":
            p["b"] = lead + (d,)
        return p

    def proj(d_in, d_out, bias):
        p = {"w": (L, d_in, d_out)}
        if bias:
            p["b"] = (L, d_out)
        return p

    bias = conf["qkv_bias"]
    if conf["mlp"] == "gelu":
        mlp = {"w_in": (L, d, ff), "b_in": (L, ff), "w_out": (L, ff, d), "b_out": (L, d)}
    else:
        mlp = {"w_gate": (L, d, ff), "w_up": (L, d, ff), "w_down": (L, ff, d)}
    shapes: Dict[str, Any] = {
        "embed": {"table": (conf["vocab_size"], d)},
        "layers": {
            "attn_norm": norm((L,)),
            "attn": {"wq": proj(d, qd, bias), "wk": proj(d, kvd, bias),
                     "wv": proj(d, kvd, bias), "wo": proj(qd, d, False)},
            "mlp_norm": norm((L,)),
            "mlp": mlp,
        },
        "final_norm": norm(()),
    }
    if conf["pos_embedding"] == "learned":
        shapes["pos"] = {"table": (conf["max_position"], d)}
    if not conf["tie_embeddings"]:
        shapes["lm_head"] = {"table": (conf["vocab_size"], d)}
    return shapes


def matrix_params(conf: Dict[str, Any]) -> int:
    """Weights a decoded token multiplies by: every layer's products and
    the head (the embedding and position lookups multiply nothing; norms
    and biases are left out)."""
    d, hd, ff = conf["d_model"], conf["head_dim"], conf["d_ff"]
    qd, kvd = conf["n_heads"] * hd, conf["n_kv_heads"] * hd
    attn = d * qd + 2 * d * kvd + qd * d
    mlp = (2 if conf["mlp"] == "gelu" else 3) * d * ff
    return conf["n_layers"] * (attn + mlp) + conf["vocab_size"] * d


def decode_flops(conf: Dict[str, Any], batch: int, pos: int) -> int:
    """Model FLOPs of one decode step of ``batch`` sequences whose new
    token sits at position ``pos``: two per weight applied, and the scores
    and the weighted sum over the ``pos + 1`` positions it attends to
    (``2 * hd`` each, for every query head and layer)."""
    attn = conf["n_layers"] * conf["n_heads"] * 4 * conf["head_dim"] * (pos + 1)
    return batch * (2 * matrix_params(conf) + attn)


def cache_shapes(conf: Dict[str, Any], batch: int, length: int) -> Dict[str, Any]:
    """The decode caches the context lives in, by the program's state keys:
    keys after RoPE and values, (L, batch, length, G, hd)."""
    shape = (conf["n_layers"], batch, length, conf["n_kv_heads"], conf["head_dim"])
    return {"kv_k": shape, "kv_v": shape}


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale for the tensor
    (its largest magnitude maps to 448), back in float32."""
    s = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _norm(conf, p, x):
    g = p["g"].float()
    if conf["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + conf["norm_eps"]) * g + p["b"].float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + conf["norm_eps"]) * g


def _rope(x, positions, theta):
    """Rotate-half RoPE on (R, S, heads, hd) at ``positions`` (S,); the
    angles in float64, then float32."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = positions.to(torch.float64)[:, None] * inv                 # (S, hd/2)
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def logits(conf: Dict[str, Any], params: Dict[str, Any], ctx: Dict[str, torch.Tensor],
           tokens: torch.Tensor, *, quant: Optional[str] = None) -> torch.Tensor:
    """Float32 logits (R, S, vocab) of ``tokens`` (R, S) at positions
    ``C .. C + S - 1`` after the context ``ctx`` (:func:`cache_shapes`'
    caches cut to the R requests and their C context positions).
    ``params`` is :func:`param_shapes`' tree of tensors (any float dtype;
    each layer is read in float32).  ``quant="fp8"`` rounds both operands
    of every weight product through float8 e4m3 (the control)."""
    q8 = fp8 if quant == "fp8" else (lambda t: t)
    if quant not in (None, "fp8"):
        raise ValueError(f"unknown quantisation {quant!r}")

    def lin(p, x):
        y = q8(x) @ q8(p["w"].float())
        return y + p["b"].float() if "b" in p else y

    ctx_k, ctx_v = ctx["kv_k"], ctx["kv_v"]
    R, S = tokens.shape
    L, _, C, G, hd = ctx_k.shape
    H = conf["n_heads"]
    rep = H // G
    positions = torch.arange(C, C + S, device=tokens.device)
    x = params["embed"]["table"][tokens].float()
    if conf["pos_embedding"] == "learned":
        x = x + params["pos"]["table"][C: C + S].float()[None]
    # new token j sees the whole context and new tokens 0..j
    allowed = torch.cat([torch.ones(S, C, dtype=torch.bool, device=x.device),
                         torch.ones(S, S, dtype=torch.bool, device=x.device).tril()], dim=1)
    for layer in range(L):
        lp = _layer(params["layers"], layer)
        h = _norm(conf, lp["attn_norm"], x)
        q = lin(lp["attn"]["wq"], h).reshape(R, S, H, hd)
        k = lin(lp["attn"]["wk"], h).reshape(R, S, G, hd)
        v = lin(lp["attn"]["wv"], h).reshape(R, S, G, hd)
        if conf["use_rope"]:
            q, k = _rope(q, positions, conf["rope_theta"]), _rope(k, positions, conf["rope_theta"])
        keys = torch.cat([ctx_k[layer].float(), k], dim=1)             # (R, C + S, G, hd)
        vals = torch.cat([ctx_v[layer].float(), v], dim=1)
        qg = q.reshape(R, S, G, rep, hd)
        s = torch.einsum("rsgeh,rtgh->rgest", qg, keys) / math.sqrt(hd)
        s = s.masked_fill(~allowed, float("-inf"))
        o = torch.einsum("rgest,rtgh->rsgeh", torch.softmax(s, dim=-1), vals)
        x = x + lin(lp["attn"]["wo"], o.reshape(R, S, H * hd))
        h = _norm(conf, lp["mlp_norm"], x)
        m = lp["mlp"]
        if conf["mlp"] == "gelu":
            y = lin({"w": m["w_out"], "b": m["b_out"]},
                    _gelu_tanh(lin({"w": m["w_in"], "b": m["b_in"]}, h)))
        else:
            g = lin({"w": m["w_gate"]}, h)
            y = lin({"w": m["w_down"]}, g * torch.sigmoid(g) * lin({"w": m["w_up"]}, h))
        x = x + y
    x = _norm(conf, params["final_norm"], x)
    head = params["embed"] if conf["tie_embeddings"] else params["lm_head"]
    return lin({"w": head["table"].float().T}, x)


def _layer(stack, i):
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]
