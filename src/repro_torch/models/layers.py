"""Shared primitive layers: norms, projections, RoPE and M-RoPE, MLPs,
embeddings.

Params are plain nested dicts of tensors in the reference's layout
(``{"w": (d_in, d_out)}`` dense weights).  Compute dtype is bf16, with
f32 for norms, softmax and logits; each cast sits where the reference's
``repro.models.layers`` has it.  Where the reference accumulates a bf16
product in f32 (``preferred_element_type=f32``), the port casts the bf16
operands to f32 (exact) and multiplies in f32.
"""

from __future__ import annotations

import bisect
import itertools
import math

import torch

__all__ = [
    "dense",
    "rmsnorm",
    "layernorm",
    "rope_freqs",
    "apply_rope",
    "mrope_section_ids",
    "apply_mrope",
    "silu_bf16",
    "swiglu",
    "gelu_tanh_bf16",
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


def mrope_section_ids(sections, n: int) -> list:
    """Which of (t, h, w) drives each of the ``n`` frequency pairs:
    ``jnp.repeat(arange(3), sections, total_repeat_length=n)``, which
    starts section ``i`` at the sum of the sections before it and fills
    each pair with the last section started at or before it.  So sections
    that sum to more than ``n`` are cut short, and where they sum to less
    the last id runs on to the end: (16, 24, 24) at ``n = 16`` is all 0,
    (2, 3, 3) is ``[0, 0, 1, 1, 1, 2, ..., 2]``."""
    starts = list(itertools.accumulate((int(r) for r in sections[:-1]), initial=0))
    return [bisect.bisect_right(starts, i) - 1 for i in range(n)]


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """M-RoPE (Qwen2-VL §2.1): each frequency pair rotates by the t, h or
    w position ``mrope_section_ids`` assigns it.  x: (B, S, H, hd);
    positions_thw: (B, S, 3).  With t = h = w = p it is ``apply_rope(x,
    p)`` bit for bit (the same angles)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    sec = torch.tensor(mrope_section_ids(sections, hd // 2), device=x.device)
    idx = sec.expand(*positions_thw.shape[:-1], hd // 2)
    pos = torch.gather(positions_thw.to(torch.float32), -1, idx)   # (B, S, hd/2)
    angles = pos * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` on bf16 as the reference's compiled step computes
    it: ``x * (1 / (1 + exp(-x)))`` with a bf16 round after each op (its
    HLO: ``negate``, ``exponential``, ``add``, ``divide``, ``multiply``, a
    bf16 ``convert`` after each).  ``F.silu`` rounds once."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    xc = x.to(torch.bfloat16)
    g = xc @ p["w_gate"].to(torch.bfloat16)
    u = xc @ p["w_up"].to(torch.bfloat16)
    return (silu_bf16(g) * u) @ p["w_down"].to(torch.bfloat16)


# jax.nn.gelu's constants as bf16 values (0.0446777344 and 0.796875), exact
# as Python floats, so a bf16 tensor times one rounds as in the reference
_GELU_CUBE = float(torch.tensor(0.044715, dtype=torch.bfloat16))
_GELU_SCALE = float(torch.tensor(math.sqrt(2.0 / math.pi), dtype=torch.bfloat16))


def gelu_tanh_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form) on bf16 as the reference's compiled
    decode step computes it: every op rounds to bf16, constants included.

    The optimised HLO of the reference's jitted ``decode_step`` with
    ``mlp="gelu"`` keeps a bf16 ``convert`` after each op of the formula
    under the default XLA flags: after each of the two ``multiply``s of
    ``integer_pow`` (``x**3`` as ``(x*x)*x``), after ``0.0446777344 * .``
    (``0.044715`` in bf16), ``x + .``, ``0.796875 * .`` (``sqrt(2/pi)`` in
    bf16), ``tanh``, ``1 + .``, ``0.5 * .`` and the final ``x * .``.
    ``F.gelu(approximate="tanh")`` rounds once and keeps the constants'
    f32 values.  One difference remains: XLA on the CPU flushes subnormal
    inputs, intermediates and results to zero, and this does not.
    """
    inner = _GELU_SCALE * (x + _GELU_CUBE * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def _f32_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` of bf16 operands as the compiled reference's ``dot``: the
    operands cast to f32 (exact), multiplied in f32, rounded to bf16."""
    a = a.to(torch.bfloat16).to(torch.float32)
    return (a @ w.to(torch.bfloat16).to(torch.float32)).to(torch.bfloat16)


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """Both products as f32 ``dot``s rounded to bf16, the bias add rounded
    before the GELU (the reference's HLO); a bf16 product here sums in
    another order and lands a near-tie on the other side of a rounding."""
    h = gelu_tanh_bf16(_f32_product(x, p["w_in"]) + p["b_in"].to(torch.bfloat16))
    return _f32_product(h, p["w_out"]) + p["b_out"].to(torch.bfloat16)


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.to(torch.int64)].to(torch.bfloat16)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32: bf16 operands, f32 products and accumulation."""
    x32 = x.to(torch.bfloat16).to(torch.float32)
    t32 = p["table"].to(torch.bfloat16).to(torch.float32)
    return x32 @ t32.T
