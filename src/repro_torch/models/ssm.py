"""Mamba2 (SSD): the chunked scan over a sequence and the recurrent decode.

A port of ``repro.models.ssm``.  The forward over a sequence
(``mamba2_train``) runs the depthwise causal convolution as shifted adds
(``_causal_conv``) and the chunked SSD algorithm (``ssd_scan``): within a
chunk of ``ssd_chunk`` the quadratic form, across chunks a linear
recurrence on the (H, P, N) state.  Decode is the pure recurrence, O(1)
per token::

    state <- state * exp(dt * A) + dt * x (x) B,    y = C . state + D * x

Rounding of the decode step follows the optimised HLO of the reference's jitted
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

__all__ = ["SSMCache", "init_ssm_cache", "mamba2_decode", "mamba2_train", "ssd_scan",
           "softplus_f32"]


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


def _causal_conv(p, u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of u (B, S, C) as shifted adds in f32,
    window position by window position, then the bias and an f32 SiLU,
    rounded to u's dtype."""
    w = p["w"].to(torch.float32)
    width = w.shape[0]
    uf = u.to(torch.float32)
    S = uf.shape[1]
    y = torch.zeros_like(uf)
    for i in range(width):
        shift = width - 1 - i
        ui = torch.nn.functional.pad(uf, (0, 0, shift, 0))[:, :S]
        y = y + ui * w[i][None, None, :]
    return layers.silu_bf16(y + p["b"].to(torch.float32)).to(u.dtype)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
             Cc: torch.Tensor, D: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked SSD. xh: (B, S, H, P); dt: (B, S, H) (after softplus);
    A: (H,) < 0; Bc, Cc: (B, S, N) (one group); D: (H,).  Returns
    (B, S, H, P) bf16.

    The sequence pads to a multiple of ``Q = min(chunk, S)``.  Within a
    chunk the segment sums are masked to ``-inf`` above the diagonal
    before the ``exp`` (after it, ``inf * 0`` would give NaN); the chunk
    states then run through the inter-chunk recurrence, which hands each
    chunk the state before it; ``y_off`` adds to the diagonal part, then
    ``D * x``, then one round to bf16.
    """
    Bsz, S, H, P = xh.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bc = torch.nn.functional.pad(Bc, (0, 0, 0, pad))
        Cc = torch.nn.functional.pad(Cc, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // Q
    f32 = torch.float32
    xc = xh.reshape(Bsz, nc, Q, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, Q, H).to(f32)
    Bcc = Bc.reshape(Bsz, nc, Q, N).to(f32)
    Ccc = Cc.reshape(Bsz, nc, Q, N).to(f32)

    dA = dtc * A[None, None, None, :]                      # (B, nc, Q, H) <= 0
    cum = torch.cumsum(dA, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B, nc, Q, Q, H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    seg = torch.where(tri[None, None, :, :, None], seg, -torch.inf)
    L = torch.exp(seg)
    scores = torch.einsum("bcqn,bckn->bcqk", Ccc, Bcc)     # (B, nc, Q, Q)
    att = scores[..., None] * L * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", att, xc)

    decay_out = torch.exp(cum[:, :, -1:, :] - cum)         # (B, nc, Q, H)
    states = torch.einsum("bckn,bckh,bckhp->bchpn", Bcc, dtc * decay_out, xc)
    chunk_decay = torch.exp(dA.sum(dim=2))                 # (B, nc, H)
    s = torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
    prev = []
    for c in range(nc):                                     # the state before each chunk
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prev = torch.stack(prev, dim=1)                      # (B, nc, H, P, N)
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Ccc, s_prev, torch.exp(cum))
    y = (y_diag + y_off).reshape(Bsz, Sp, H, P)[:, :S]
    return (y + xh[:, :S].to(f32) * D[None, None, :, None]).to(torch.bfloat16)


def mamba2_train(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """The Mamba2 mixer over a whole sequence: x (B, S, D) → (B, S, D).

    ``in_proj`` and ``out_proj`` are f32 products rounded once (as in
    decode); ``dt = softplus(dt + dt_bias)`` in f32; the gate
    ``silu(z)`` rounds to bf16 and its product with ``y`` stays f32 into
    the gated rmsnorm, as in the decode step."""
    z, xin, Bc, Cc, dt, d_inner, H, N = _split_proj(p, x, cfg)
    conv_out = _causal_conv(p["conv"], torch.cat([xin, Bc, Cc], dim=-1))
    xin, Bc, Cc = torch.split(conv_out, [d_inner, N, N], dim=-1)
    A = -torch.exp(p["ssm"]["A_log"])
    dtv = softplus_f32(dt.to(torch.float32) + p["ssm"]["dt_bias"][None, None, :])
    xh = xin.reshape(*xin.shape[:2], H, cfg.ssm_head_dim)
    y = ssd_scan(xh, dtv, A, Bc, Cc, p["ssm"]["D"], cfg.ssd_chunk)
    y = y.reshape(*x.shape[:2], d_inner)
    gate = layers.silu_bf16(z.to(torch.float32)).to(torch.bfloat16)
    h = layers.rmsnorm(p["norm"], y.to(torch.float32) * gate.to(torch.float32))
    return layers._f32_product(h.to(torch.bfloat16), p["out_proj"]["w"])


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
