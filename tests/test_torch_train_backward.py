"""The training slice's custom backward passes in the port against
``jax.vjp`` of the reference's functions on the same bf16 inputs: the
fused cross-entropy, the flash attention's FlashAttention-2 backward and
the MoE dispatch and combine.

Inputs come from a numpy seed and cross to the port bit for bit; the
reference runs jitted on the CPU.  Limits:

* fused cross-entropy: every gradient entry within one bf16 step of the
  largest magnitude and at most ``CE_SHARE`` (0.1%) of entries different
  at all (both recompute the chunk logits with f32 products of bf16
  operands and round ``dlogits`` to bf16 before both products; XLA's f32
  ``exp`` differs from PyTorch's in the last bit now and then, and these
  inputs read 0 to 0.03%); the loss within ``LOSS_REL`` (1e-6): the two
  logsumexps differ in the last bit.  The control (``dlogits`` left in
  f32) differs on most entries;
* flash backward: every entry of dq, dk and dv within one bf16 step of
  the largest magnitude, and at most ``ATTN_SHARE`` (3%) of entries
  different at all: both sides compute the same f32 products, but XLA's
  f32 ``exp`` and its dot and reduce orders differ from PyTorch's in the
  last bit, so a value next to a bf16 rounding boundary now and then
  rounds to the other neighbour (these inputs read up to 0.3%, and 1.6%
  of dq at MLA's 192-long products).  The
  control (plain autograd of the dense variant, whose dv takes the
  bf16-rounded weights) differs on 40-50% of entries;
* dispatch: the token gradient equals the reference's bit for bit (each
  token's slot rows added in slot order, every add rounded to bf16, which
  is what the reference's scatter-add computes); the control (the same
  rows summed in f32 and rounded once) differs on 10-30% of entries;
* combine: ``d_out_e`` bit for bit; ``d_gate`` (f32 sums over D) within
  ``GATE_REL`` (1e-6) of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro_torch import convert
from repro_torch.models import attention, layers, moe

BF16 = jnp.bfloat16.dtype
LOSS_REL = 1e-6
CE_SHARE = 1e-3
ATTN_SHARE = 3e-2
GATE_REL = 1e-6


def _t(a):
    return convert.params_from_numpy({"a": np.asarray(a)}, device="cpu")["a"]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _bf16_gap(want, got):
    """(largest gap in bf16 steps of the largest magnitude, share differing)."""
    want, got = _f32(want), _f32(got)
    assert want.shape == got.shape
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    gap = np.abs(want - got)
    return gap.max() / step, float((gap > 0).mean())


def _bf16_close(want, got, share):
    steps, differ = _bf16_gap(want, got)
    return steps <= 1 and differ <= share


# --------------------------------------------------------------------- fused CE

# (B, S, D, V, ce_chunks, partial mask)
CE_CASES = {
    "chunked": (2, 64, 32, 100, 8, False),
    "one-chunk-S%n": (2, 60, 32, 100, 8, True),
    "partial-mask": (3, 48, 64, 257, 4, True),
}


def _ce_inputs(B, S, D, V, partial, seed):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((V, D)) * 0.5).astype(BF16)
    x = rng.standard_normal((B, S, D)).astype(BF16)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    if partial:
        mask[:, S // 2:] = 0
        mask[0, :3] = 0.5
    return table, x, labels, mask


def _ref_ce_vjp(table, x, labels, mask, n):
    fn = jax.jit(lambda t, x: ref_layers.fused_cross_entropy(t, x, labels, mask, n))
    loss, vjp = jax.vjp(fn, table, x)
    return loss, vjp(jnp.ones((), jnp.float32))


def _port_ce(table, x, labels, mask, n):
    tt, tx = _t(table).requires_grad_(), _t(x).requires_grad_()
    loss = layers.fused_cross_entropy(tt, tx, torch.from_numpy(labels),
                                      torch.from_numpy(mask), n)
    return loss.detach(), torch.autograd.grad(loss, [tt, tx])


@pytest.mark.parametrize("case", list(CE_CASES), ids=list(CE_CASES))
def test_fused_cross_entropy_backward_matches_reference(case):
    """The chunked loss and its custom backward, at S a multiple of the
    chunk count, at S not (one chunk, as the reference's fallback), and
    with a partial, fractional mask."""
    B, S, D, V, n, partial = CE_CASES[case]
    table, x, labels, mask = _ce_inputs(B, S, D, V, partial, seed=len(case))
    loss, (dt, dx) = _ref_ce_vjp(table, x, labels, mask, n)
    got_loss, (gt, gx) = _port_ce(table, x, labels, mask, n)
    assert abs(float(got_loss) - float(loss)) <= LOSS_REL * abs(float(loss))
    assert gt.dtype == torch.bfloat16 and gx.dtype == torch.bfloat16
    for name, want, got in (("dtable", dt, gt), ("dx", dx, gx)):
        steps, differ = _bf16_gap(want, got)
        assert steps <= 1 and differ <= CE_SHARE, (name, steps, differ)


def test_fused_cross_entropy_never_builds_whole_logits(monkeypatch):
    """Each product the loss runs has at most one chunk's rows: the (B, S,
    V) logits never exist, forward or backward."""
    B, S, D, V, n = 2, 64, 32, 100, 8
    table, x, labels, mask = _ce_inputs(B, S, D, V, False, seed=3)
    rows = []
    real = layers._chunk_logits

    def spy(xc, t32):
        rows.append(xc.shape[0] * xc.shape[1])
        return real(xc, t32)

    monkeypatch.setattr(layers, "_chunk_logits", spy)
    _port_ce(table, x, labels, mask, n)
    assert rows and max(rows) == B * S // n


def test_fused_ce_control_exceeds_the_limit():
    """``dlogits`` kept in f32 before the products (the reference rounds it
    to bf16): most gradient entries differ, so the exact comparison above
    sees the rounding point."""
    B, S, D, V, n = 2, 64, 32, 100, 8
    table, x, labels, mask = _ce_inputs(B, S, D, V, False, seed=7)
    _, (dt, dx) = _ref_ce_vjp(table, x, labels, mask, n)
    t32, x32 = _f32(table), _f32(x)
    logits = x32 @ t32.T
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    p[np.arange(B)[:, None], np.arange(S)[None, :], labels] -= 1.0
    dl = p * (mask / mask.sum())[..., None]
    dx_f32 = (dl @ t32).astype(BF16)
    assert not _bf16_close(dx, dx_f32, CE_SHARE)


# ----------------------------------------------------------------- flash backward

# (B, S, H, G, hd, hd_v, causal, window, q_block, kv_block)
FLASH_CASES = {
    "causal": (2, 128, 4, 2, 32, 32, True, 0, 64, 64),
    "windowed": (2, 100, 4, 2, 32, 32, True, 40, 32, 32),
    "non-causal": (2, 100, 4, 2, 32, 32, False, 0, 64, 64),
    "padded-S": (1, 90, 4, 2, 32, 32, True, 0, 32, 64),
    "gqa-rep4": (1, 128, 8, 2, 32, 32, True, 0, 32, 64),
    "mla-192-128": (1, 64, 2, 2, 192, 128, True, 0, 32, 32),
}


def _flash_inputs(B, S, H, G, hd, hd_v, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(BF16),
            rng.standard_normal((B, S, G, hd)).astype(BF16),
            rng.standard_normal((B, S, G, hd_v)).astype(BF16),
            rng.standard_normal((B, S, H, hd_v)).astype(BF16))


def _ref_flash_vjp(q, k, v, dout, causal, window, qb, kb):
    fn = jax.jit(lambda q, k, v: ref_attention.flash_attention(
        q, k, v, causal=causal, window=window, q_block=qb, kv_block=kb))
    _, vjp = jax.vjp(fn, q, k, v)
    return vjp(jnp.asarray(dout))


@pytest.mark.parametrize("case", list(FLASH_CASES), ids=list(FLASH_CASES))
def test_flash_backward_matches_reference(case):
    """Causal, windowed (blocks wholly masked before the live ones),
    non-causal, S padded to the blocks, GQA at 4 query heads a KV head, and
    MLA's 192-wide q/k against its 128-wide value."""
    B, S, H, G, hd, hd_v, causal, window, qb, kb = FLASH_CASES[case]
    q, k, v, dout = _flash_inputs(B, S, H, G, hd, hd_v, seed=len(case))
    want = _ref_flash_vjp(q, k, v, dout, causal, window, qb, kb)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = attention.flash_attention(tq, tk, tv, causal=causal, window=window,
                                    q_block=qb, kv_block=kb)
    got = torch.autograd.grad(out, [tq, tk, tv], _t(dout))
    for name, w, g in zip("qkv", want, got):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape, name
        steps, differ = _bf16_gap(w, g)
        assert steps <= 1 and differ <= ATTN_SHARE, (name, steps, differ)


def test_flash_backward_keeps_no_score_block():
    """The autograd graph of the flash loop holds q, k, v, the output and
    the per-row logsumexp: nothing of size q_block x kv_block."""
    B, S, H, G, hd = 1, 256, 4, 2, 32
    q, k, v, _ = _flash_inputs(B, S, H, G, hd, hd, seed=5)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t,
                                                  lambda t: t):
        attention.flash_attention(tq, tk, tv, causal=True, q_block=64, kv_block=64)
    assert saved and max(saved) <= B * S * H * hd
    assert sum(saved) <= 5 * B * S * H * hd


def test_flash_backward_control_exceeds_the_limit():
    """Plain autograd of the dense variant (softmax weights rounded to bf16
    before the PV product, so dv takes the rounded weights, where the
    reference's backward takes the f32 ``p``) fails the limit."""
    B, S, H, G, hd, hd_v, causal, window, qb, kb = FLASH_CASES["causal"]
    q, k, v, dout = _flash_inputs(B, S, H, G, hd, hd_v, seed=len("causal"))
    want = _ref_flash_vjp(q, k, v, dout, causal, window, qb, kb)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = attention.dense_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, [tq, tk, tv], _t(dout))
    assert not all(_bf16_close(w, g, ATTN_SHARE) for w, g in zip(want, got))


# ---------------------------------------------------------------- dispatch, combine

def _routing(T, K, E, seed):
    rng = np.random.default_rng(seed)
    probs = rng.random((T, E))
    idx = np.argsort(-probs, axis=1)[:, :K].astype(np.int32)
    return rng, idx


@pytest.mark.parametrize("cf", [0.6, 2.0], ids=["pairs-drop", "no-drop"])
def test_dispatch_backward_matches_reference(cf):
    """The gather's deterministic backward against ``jax.vjp`` of
    ``_dispatch_one``, where a third of the pairs drop and where none do."""
    T, K, E, D = 64, 4, 8, 32
    C = int(T * K / E * cf) + 1
    rng, idx = _routing(T, K, E, seed=int(cf * 10))
    xt = rng.standard_normal((T, D)).astype(BF16)
    dbuf = rng.standard_normal((E, C, D)).astype(BF16)
    fn = jax.jit(lambda x: ref_moe._dispatch_one(x, jnp.asarray(idx), C, E)[0])
    buf, vjp = jax.vjp(fn, xt)
    (want,) = vjp(jnp.asarray(dbuf))
    tx = _t(xt).requires_grad_()
    tbuf, _, pos = moe.dispatch(tx, torch.from_numpy(idx).long(), C, E)
    np.testing.assert_array_equal(_f32(tbuf), _f32(buf))
    assert (int((pos < 0).sum()) > 0) == (cf < 1)
    (got,) = torch.autograd.grad(tbuf, [tx], _t(dbuf))
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_dispatch_backward_control_exceeds_the_limit():
    """The same slot rows summed in f32 and rounded once differ from the
    reference's bf16 adds on a large share of entries."""
    T, K, E, D = 64, 4, 8, 32
    C = int(T * K / E * 2.0) + 1
    rng, idx = _routing(T, K, E, seed=20)
    xt = rng.standard_normal((T, D)).astype(BF16)
    dbuf = rng.standard_normal((E, C, D)).astype(BF16)
    fn = jax.jit(lambda x: ref_moe._dispatch_one(x, jnp.asarray(idx), C, E)[0])
    _, vjp = jax.vjp(fn, xt)
    (want,) = vjp(jnp.asarray(dbuf))
    _, sort, pos = moe.dispatch(_t(xt), torch.from_numpy(idx).long(), C, E)
    sorted_e = torch.from_numpy(idx).long().reshape(-1)[sort]
    rows = torch.zeros((T * K, D))
    keep = pos >= 0
    rows[keep] = _t(dbuf).float()[sorted_e[keep], pos[keep]]
    f32_sum = torch.zeros((T, D)).index_add_(0, sort // K, rows).to(torch.bfloat16)
    assert float((_f32(f32_sum) != _f32(want)).mean()) > 0.05


@pytest.mark.parametrize("cf", [0.6, 2.0], ids=["pairs-drop", "no-drop"])
def test_combine_backward_matches_reference(cf):
    """``_combine_one``'s custom backward: the gather of ``dy * gate`` into
    the live slots, and ``d_gate`` from the recomputed rows."""
    T, K, E, D = 64, 4, 8, 32
    C = int(T * K / E * cf) + 1
    rng, idx = _routing(T, K, E, seed=30 + int(cf * 10))
    xt = rng.standard_normal((T, D)).astype(BF16)
    out_e = rng.standard_normal((E, C, D)).astype(BF16)
    gate = rng.random((T, K)).astype(np.float32)
    dy = rng.standard_normal((T, D)).astype(BF16)
    _, sort_j, pos_j = ref_moe._dispatch_one(jnp.asarray(xt), jnp.asarray(idx), C, E)
    fn = jax.jit(lambda o, g: ref_moe._combine_one(o, sort_j, pos_j, jnp.asarray(idx), g))
    y, vjp = jax.vjp(fn, out_e, gate)
    d_out, d_gate = vjp(jnp.asarray(dy))
    _, sort, pos = moe.dispatch(_t(xt), torch.from_numpy(idx).long(), C, E)
    to, tg = _t(out_e).requires_grad_(), torch.from_numpy(gate).requires_grad_()
    ty = moe.combine(to, sort, pos, torch.from_numpy(idx).long(), tg)
    np.testing.assert_array_equal(_f32(ty), _f32(y))
    g_out, g_gate = torch.autograd.grad(ty, [to, tg], _t(dy))
    np.testing.assert_array_equal(_f32(g_out), _f32(d_out))
    assert g_gate.dtype == torch.float32
    gap = np.abs(_f32(g_gate) - _f32(d_gate)).max()
    assert gap <= GATE_REL * np.abs(_f32(d_gate)).max()
