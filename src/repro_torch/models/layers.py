"""Shared primitive layers: norms, projections, RoPE, MLPs, embeddings.

Params are plain nested dicts of tensors in the reference's layout
(``{"w": (d_in, d_out)}`` dense weights).  Compute dtype is bf16, with
f32 for norms, softmax and logits; each cast sits where the reference's
``repro.models.layers`` has it.  Where the reference accumulates a bf16
product in f32 (``preferred_element_type=f32``), the port casts the bf16
operands to f32 (exact) and multiplies in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "dense",
    "rmsnorm",
    "layernorm",
    "rope_freqs",
    "apply_rope",
    "swiglu",
    "gelu_mlp",
    "embed",
    "unembed",
]


def dense(p, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * p["g"].to(torch.float32)).to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].to(torch.float32) + p["b"].to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs   # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    xc = x.to(torch.bfloat16)
    g = xc @ p["w_gate"].to(torch.bfloat16)
    u = xc @ p["w_up"].to(torch.bfloat16)
    return (F.silu(g) * u) @ p["w_down"].to(torch.bfloat16)


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    xc = x.to(torch.bfloat16)
    h = F.gelu(
        xc @ p["w_in"].to(torch.bfloat16) + p["b_in"].to(torch.bfloat16),
        approximate="tanh",               # jax.nn.gelu's default
    )
    return h @ p["w_out"].to(torch.bfloat16) + p["b_out"].to(torch.bfloat16)


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.to(torch.int64)].to(torch.bfloat16)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32: bf16 operands, f32 products and accumulation."""
    x32 = x.to(torch.bfloat16).to(torch.float32)
    t32 = p["table"].to(torch.bfloat16).to(torch.float32)
    return x32 @ t32.T
