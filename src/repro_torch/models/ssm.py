"""Mamba2 (SSD) recurrent decode: the decode half of ``repro.models.ssm``.

Decode is the pure recurrence, O(1) per token::

    state <- state * exp(dt * A) + dt * x (x) B,    y = C . state + D * x

The chunked training scan (``ssd_scan``), the causal convolution over a
sequence (``_causal_conv``) and ``mamba2_train`` belong to prefill and
training and are not ported yet.

Rounding follows the optimised HLO of the reference's jitted
``mamba_block_decode`` (default XLA flags), not its eager ops:

* ``in_proj`` is an f32 product of the bf16 operands rounded once to bf16
  (every split piece reads the rounded product);
* the convolution sums its ``ssm_conv`` f32 products in window order, adds
  the bias, and applies SiLU in f32 as ``x * (1 / (1 + exp(-x)))``, with no
  rounding: ``x``, ``B`` and ``C`` reach the recurrence in f32;
* ``softplus`` is ``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` =
  ``max(x, 0) + log1p(exp(-|x|))`` (NaN passes through), not
  ``F.softplus`` with its threshold;
* ``dt * x (x) B`` multiplies ``dt * B`` first, then ``x``;
* ``y`` rounds to bf16 once after ``+ D * x``; the gate
  ``silu(z.astype(f32)).astype(bf16)`` rounds once; their product stays f32
  into the gated rmsnorm (the compiled step drops eager JAX's bf16 round
  of ``y * gate`` before the norm's f32 cast);
* ``out_proj`` is again an f32 product rounded once.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import layers

__all__ = ["SSMCache", "init_ssm_cache", "mamba2_decode", "softplus_f32"]


def _dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, heads, state size, conv channels)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    return d_inner, d_inner // cfg.ssm_head_dim, N, d_inner + 2 * N


def _split_proj(p, x: torch.Tensor, cfg):
    """``in_proj`` and its split into (z, x, B, C, dt), bf16."""
    d_inner, H, N, _ = _dims(cfg)
    zxbcdt = layers._f32_product(x, p["in_proj"]["w"])
    z, xin, Bc, Cc, dt = torch.split(zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)
    return z, xin, Bc, Cc, dt, d_inner, H, N


def softplus_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) on f32: ``max(x, 0) +
    log1p(exp(-|x|))``, NaN passed through, as the compiled step's HLO."""
    out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


class SSMCache(NamedTuple):
    state: torch.Tensor      # (L, B, H, P, N) f32
    conv: torch.Tensor       # (L, B, width - 1, conv_dim) bf16


def init_ssm_cache(cfg, batch: int, n_layers: int, device) -> SSMCache:
    _, H, N, conv_dim = _dims(cfg)
    return SSMCache(
        torch.zeros((n_layers, batch, H, cfg.ssm_head_dim, N), dtype=torch.float32,
                    device=device),
        torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=torch.bfloat16,
                    device=device),
    )


def mamba2_decode(p, x: torch.Tensor, state: torch.Tensor, conv_cache: torch.Tensor, cfg):
    """One-token recurrent step. x: (B, 1, D) bf16; state: (B, H, P, N) f32;
    conv_cache: (B, width - 1, conv_dim) bf16.  Returns (y, state, conv_cache)."""
    z, xin, Bc, Cc, dt, d_inner, H, N = _split_proj(p, x, cfg)
    u = torch.cat([xin, Bc, Cc], dim=-1)[:, 0]                       # (B, conv_dim)
    w = p["conv"]["w"].to(torch.float32)
    hist = torch.cat([conv_cache.to(torch.float32), u.to(torch.float32)[:, None]], dim=1)
    prods = hist * w[None]
    conv = prods[:, 0]
    for i in range(1, w.shape[0]):           # the reduce's order: window position by position
        conv = conv + prods[:, i]
    # layers.silu_bf16's ops on f32 operands: the HLO's f32 SiLU, op by op
    conv = layers.silu_bf16(conv + p["conv"]["b"].to(torch.float32))
    conv_cache = hist[:, 1:].to(conv_cache.dtype)                    # exact: bf16 values

    xin, Bc, Cc = torch.split(conv, [d_inner, N, N], dim=-1)
    A = -torch.exp(p["ssm"]["A_log"])
    dtv = softplus_f32(dt[:, 0].to(torch.float32) + p["ssm"]["dt_bias"][None, :])
    dA = torch.exp(dtv * A[None, :])                                 # (B, H)
    xh = xin.reshape(-1, H, cfg.ssm_head_dim)                        # (B, H, P)
    dtB = dtv[:, :, None] * Bc[:, None, :]                           # (B, H, N)
    state = state * dA[:, :, None, None] + xh[..., None] * dtB[:, :, None, :]
    y = torch.matmul(state, Cc[:, None, :, None])[..., 0]           # (B, H, P)
    y = y + xh * p["ssm"]["D"][None, :, None]
    y = y.reshape(-1, 1, d_inner).to(torch.bfloat16)
    gate = layers.silu_bf16(z.to(torch.float32)).to(torch.bfloat16)
    g = y.to(torch.float32) * gate.to(torch.float32)                 # f32 into the norm
    h = layers.rmsnorm(p["norm"], g).to(torch.bfloat16)
    return layers._f32_product(h, p["out_proj"]["w"]), state, conv_cache
