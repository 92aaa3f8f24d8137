"""Shared primitive layers: norms, projections, RoPE and M-RoPE, MLPs,
embeddings, and the cross-entropy losses (plain, and fused with the
unembed under a custom backward).

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

from ..distributed.sharding import (from_local_like, gather_axis, is_dtensor, local_tensor, lshard,
                                    product_input, product_output)

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
    "cross_entropy",
    "fused_cross_entropy",
]


def _weight(w: torch.Tensor) -> torch.Tensor:
    """A weight as a product reads it: on a mesh, its ZeRO-3 cut over
    'data' gathered (the all-gather GSPMD puts before each use), its cut
    over 'model' kept; a plain tensor passes through."""
    return gather_axis(w, "data")


def dense(p, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    if is_dtensor(x):
        y = product_output(product_input(x).to(compute_dtype) @ _weight(p["w"]).to(compute_dtype))
    else:
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
    if is_dtensor(x):
        xc = product_input(x).to(torch.bfloat16)
        g = xc @ _weight(p["w_gate"]).to(torch.bfloat16)
        u = xc @ _weight(p["w_up"]).to(torch.bfloat16)
        return product_output(product_input(silu_bf16(g) * u)
                              @ _weight(p["w_down"]).to(torch.bfloat16))
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
    if is_dtensor(a):
        a, w = product_input(a), _weight(w)
    a = a.to(torch.bfloat16).to(torch.float32)
    return product_output(a @ w.to(torch.bfloat16).to(torch.float32)).to(torch.bfloat16)


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """Both products as f32 ``dot``s rounded to bf16, the bias add rounded
    before the GELU (the reference's HLO); a bf16 product here sums in
    another order and lands a near-tie on the other side of a rounding."""
    h = gelu_tanh_bf16(_f32_product(x, p["w_in"]) + p["b_in"].to(torch.bfloat16))
    return _f32_product(h, p["w_out"]) + p["b_out"].to(torch.bfloat16)


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    """Table rows of ``tokens`` in bf16.  Through ``F.embedding``, whose
    backward on the card sums each row's gradients in a fixed order
    (indexing's backward, ``index_put_(accumulate=True)``, adds them in an
    order that changes from run to run)."""
    if is_dtensor(p["table"]):
        return _embed_mesh(p["table"], tokens)
    return torch.nn.functional.embedding(tokens.to(torch.int64), p["table"]).to(torch.bfloat16)


def _embed_mesh(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The vocab-parallel lookup on DTensors: each rank looks its tokens up
    in its rows of the table (the vocab cut, any ZeRO-3 cut of d_model
    gathered), zero where another rank holds the row; the rows then sum
    over the vocab's axis.  Each rank's table gradient is a partial sum
    over the batch's axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    tokens = lshard(tokens, "batch", None)
    mesh = table.device_mesh
    t_pl, x_pl = list(table.placements), list(tokens.placements)
    rows = [Shard(0) if tp.is_shard(0) and not xp.is_shard(0) else Replicate()
            for tp, xp in zip(t_pl, x_pl)]
    table = table.redistribute(mesh, rows)
    out_pl = [Shard(0) if xp.is_shard(0) else Partial() if rp.is_shard(0) else Replicate()
              for xp, rp in zip(x_pl, rows)]
    grad_pl = [rp if rp.is_shard(0) else Partial() if xp.is_shard(0) else Replicate()
               for xp, rp in zip(x_pl, rows)]
    t_loc = local_tensor(table, grad_pl)
    v0, n = 0, t_loc.shape[0]
    for m, rp in enumerate(rows):
        if rp.is_shard(0):
            v0 = v0 * mesh.size(m) + mesh.get_local_rank(m)
    v0 *= n
    tok = tokens.to_local().to(torch.int64) - v0
    held = (tok >= 0) & (tok < n)
    out = torch.nn.functional.embedding(torch.where(held, tok, 0), t_loc)
    out = torch.where(held[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return from_local_like(out, table, out_pl).to(torch.bfloat16)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32: bf16 operands, f32 products and accumulation."""
    table = p["table"]
    if is_dtensor(x):
        x, table = product_input(x), _weight(table)
    x32 = x.to(torch.bfloat16).to(torch.float32)
    t32 = table.to(torch.bfloat16).to(torch.float32)
    return x32 @ t32.T


def _token_sums(x, *rest, local):
    """On DTensors: ``x`` (B, S, ...) and ``rest`` (B, S) cut by batch and
    (sequence-parallel) by sequence, whole in every other dimension; then
    ``local`` of each rank's local tensors → its (numerator, denominator)
    token sums, which add up over the ranks that hold different tokens.
    Returns the global ``numerator / max(denominator, 1)``."""
    from torch.distributed.tensor import Partial, Replicate

    x = lshard(x, "batch", "seq_sp", *([None] * (x.dim() - 2)))
    rest = [r if r is None else lshard(r, "batch", "seq_sp") for r in rest]
    summed = [Partial() if p.is_shard() else Replicate() for p in x.placements]
    num, den = local(*(r if r is None else local_tensor(r) for r in [x] + rest))
    num, den = (from_local_like(t, x, summed) for t in (num, den))
    return num / torch.clamp_min(den, 1.0)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's negative log-likelihood of its label, in f32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels.to(torch.int64)[..., None])[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor = None) -> torch.Tensor:
    """Mean negative log-likelihood over valid positions: f32 logits
    (..., V), int labels (...), an optional mask (...) of weights.  On
    DTensors each rank takes its tokens' rows whole (vocab and all) and
    the sums add up over the ranks (:func:`_token_sums`)."""
    if is_dtensor(logits):
        if mask is None:
            mask = torch.ones_like(labels, dtype=torch.float32)

        def local(lg, lab, m):
            m = m.to(torch.float32)
            return (_nll(lg, lab) * m).sum(), m.sum()

        return _token_sums(logits, labels, mask, local=local)
    nll = _nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _ce_chunks(S: int, n_chunks: int) -> int:
    """The reference's chunk count: ``n_chunks`` where it divides S, else 1."""
    return n_chunks if S % n_chunks == 0 else 1


def _chunk_logits(xc: torch.Tensor, t32: torch.Tensor) -> torch.Tensor:
    """(B, c, D) rows against the (V, D) table: bf16 operands, f32 products."""
    return xc.to(torch.bfloat16).to(torch.float32) @ t32.T


class _FusedCE(torch.autograd.Function):
    """The reference's ``fused_cross_entropy`` with its custom VJP.

    The forward runs the sequence in chunks and keeps each row's
    logsumexp (n, B, c); the backward recomputes each chunk's logits and
    emits ``dlogits = (softmax - onehot) * mask * g / msum``, rounded to
    bf16 before both products (f32 products of bf16 operands); ``dtable``
    sums over chunks in f32 and is cast to the table's dtype once, ``dx``
    is cast to x's dtype.  One (B, c, V) f32 block of logits lives at a
    time: the (B, S, V) logits never exist whole.
    """

    @staticmethod
    def forward(ctx, table, x, labels, mask, n_chunks):
        B, S, D = x.shape
        n = _ce_chunks(S, n_chunks)
        c = S // n
        t32 = table.to(torch.bfloat16).to(torch.float32)
        lab = labels.to(torch.int64)
        mf = mask.to(torch.float32)
        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        msum = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for i in range(n):
            sl = slice(i * c, (i + 1) * c)
            logits = _chunk_logits(x[:, sl], t32)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, lab[:, sl, None])[..., 0]
            nll_sum = nll_sum + ((lse - tgt) * mf[:, sl]).sum()
            msum = msum + mf[:, sl].sum()
            lses.append(lse)
        ctx.save_for_backward(table, x, lab, mf, torch.stack(lses), msum)
        ctx.n = n
        return nll_sum / torch.clamp_min(msum, 1.0)

    @staticmethod
    def backward(ctx, g):
        table, x, lab, mf, lses, msum = ctx.saved_tensors
        B, S, D = x.shape
        n = ctx.n
        c = S // n
        t32 = table.to(torch.bfloat16).to(torch.float32)
        scale = g / torch.clamp_min(msum, 1.0)
        dtable = torch.zeros((table.shape[0], D), dtype=torch.float32, device=x.device)
        dx = torch.empty((B, S, D), dtype=x.dtype, device=x.device)
        for i in range(n):
            sl = slice(i * c, (i + 1) * c)
            xc = x[:, sl].to(torch.bfloat16).to(torch.float32)
            p = torch.exp(xc @ t32.T - lses[i][..., None])
            # p - onehot: 1 off the label's entry, exactly
            p.scatter_add_(-1, lab[:, sl, None], torch.full((B, c, 1), -1.0, device=x.device))
            dl = (p * (mf[:, sl] * scale)[..., None]).to(torch.bfloat16).to(torch.float32)
            dx[:, sl] = (dl @ t32).to(x.dtype)
            dtable = dtable + dl.reshape(B * c, -1).T @ xc.reshape(B * c, D)
        return dtable.to(table.dtype), dx, None, None, None


def fused_cross_entropy(table: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                        mask: torch.Tensor, n_chunks: int = 8) -> torch.Tensor:
    """Unembed and mean cross-entropy in sequence chunks: ``table`` (V, D),
    ``x`` (B, S, D), ``labels`` and ``mask`` (B, S) -> the f32 loss
    ``sum(nll * mask) / max(sum(mask), 1)``.  ``n_chunks`` chunks where
    they divide S, else one.

    On DTensors the table is gathered whole and each rank runs the chunks
    of its own tokens (:func:`_token_sums`); its table gradient is a
    partial sum over the ranks."""
    if is_dtensor(x):
        from torch.distributed.tensor import Partial, Replicate

        whole = table.redistribute(table.device_mesh, [Replicate()] * table.device_mesh.ndim)

        def local(xl, lab, m):
            summed = [Partial() if p.is_shard() else Replicate()
                      for p in lshard(x, "batch", "seq_sp", None).placements]
            msum = m.to(torch.float32).sum()
            mean = _FusedCE.apply(local_tensor(whole, summed), xl, lab, m, n_chunks)
            return mean * torch.clamp_min(msum, 1.0), msum

        return _token_sums(x, labels, mask, local=local)
    return _FusedCE.apply(table, x, labels, mask, n_chunks)
