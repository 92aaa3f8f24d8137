"""The forward pass's modules in the port against the reference, one by
one: the blockwise flash attention and the dense variant, the GQA and MLA
projections and attention over a sequence, the causal convolution, the
chunked SSD scan, the Mamba2 mixer over a sequence, and ``moe_apply``
with its aux loss at the configs' capacity factor, where tokens drop.

Inputs come from a numpy seed and cross to the port bit for bit
(``convert.params_from_numpy``); the reference runs jitted, as its forward
runs.  Limits:

* bf16 outputs (projections, attention, the SSD scan, the mixer): every
  entry within one bf16 step of the largest magnitude, and at most
  ``ATTN_SHARE`` (0.5%) of entries different at all (``SSD_SHARE``, 1%,
  for the scan and the mixer).  Both sides run the same ops at the same
  rounding points in f32, but XLA's f32 ``exp`` and its dot and reduce
  orders differ from PyTorch's in the last bit, so an f32 value lying
  next to a bf16 rounding boundary now and then rounds to the other
  neighbour: these inputs read 0 to 0.08% of attention entries, up to
  0.02% of a projection's, 0.03% of the scan's.  After an output
  projection (``gqa_train``, ``mla_train``) one such entry reaches its
  whole row, so there the share is ``ROW_SHARE`` (5%): up to 1.7% read;
* ``moe_apply``: ``y`` within ``REL_TOL`` (1e-4) of its largest value,
  ``aux`` within 1e-6, the dispatch exactly the reference's;
* the bf16 controls (the flash loop with ``p`` left in f32 before the PV
  product, a dense softmax in place of the flash loop, the scale
  ``hd ** -0.5`` unrounded) differ on 10-60% of entries, far above
  ``ATTN_SHARE``: ``test_bf16_controls_exceed_the_limit``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention
from repro.models import build_model
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention, moe, ssm

REL_TOL = 1e-4
ATTN_SHARE = 5e-3
SSD_SHARE = 1e-2
ROW_SHARE = 5e-2
BF16 = jnp.bfloat16.dtype


def _pair(name):
    return ref_get_config(name).reduced(), get_config(name).reduced()


def _layer(jcfg, key, path, seed=0):
    """One layer's subtree ``path`` of ``key`` from a numpy-seeded param
    tree (``standard_normal * 0.02`` a leaf, as the other port tests)."""
    leaves, treedef = jax.tree_util.tree_flatten(build_model(jcfg).abstract_params())
    rng = np.random.default_rng(seed)
    np_leaves = [(rng.standard_normal(l.shape) * 0.02).astype(np.dtype(l.dtype)) for l in leaves]
    tree = jax.tree_util.tree_unflatten(treedef, np_leaves)[key]
    for k in path:
        tree = tree[k]
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _t(a):
    """A numpy array (bf16 included) as a CPU tensor, bit for bit."""
    return convert.params_from_numpy({"a": np.asarray(a)}, device="cpu")["a"]


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _bf16_close(want, got: torch.Tensor, share: float) -> float:
    """``got`` within one bf16 step of ``want``'s largest magnitude
    everywhere, different on at most ``share`` of entries; returns the
    share that differ."""
    want = _f32(want)
    got = got.float().numpy()
    assert got.shape == want.shape
    top = np.abs(want).max()
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    gap = np.abs(want - got)
    assert gap.max() <= step, (gap.max(), step)
    differ = float((gap > 0).mean())
    assert differ <= share, differ
    return differ


def _qkv_inputs(B, S, H, G, hd, hd_v, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(BF16),
            rng.standard_normal((B, S, G, hd)).astype(BF16),
            rng.standard_normal((B, S, G, hd_v)).astype(BF16))


# (B, S, H, G, hd, hd_v, causal, window, q_block, kv_block)
FLASH_CASES = {
    "causal": (2, 100, 4, 2, 32, 32, True, 0, 64, 64),
    "bidirectional": (2, 100, 4, 2, 32, 32, False, 0, 64, 64),
    "window": (2, 100, 4, 2, 32, 32, True, 40, 64, 64),
    "window-blocks-of-32": (1, 128, 4, 2, 32, 32, True, 40, 32, 32),
    "mqa": (2, 100, 4, 1, 32, 32, True, 0, 64, 64),
    "mla-widths": (1, 100, 4, 4, 48, 32, True, 0, 64, 64),
    "hd-128-q32-kv64": (2, 96, 8, 2, 128, 128, True, 0, 32, 64),
    "hd-112": (1, 64, 4, 2, 112, 112, True, 0, 64, 64),
    "one-block": (2, 40, 4, 2, 32, 32, True, 0, 64, 64),
}


def _ref_flash(q, k, v, causal, window, qb, kb):
    fn = jax.jit(lambda q, k, v: ref_attention.flash_attention(
        q, k, v, causal=causal, window=window, q_block=qb, kv_block=kb))
    return fn(q, k, v)


@pytest.mark.parametrize("case", list(FLASH_CASES), ids=list(FLASH_CASES))
def test_flash_attention_matches_reference(case):
    """Causal and not, with a window, S not a multiple of either block,
    GQA (rep 2), MQA (G = 1), MLA's hd_v != hd, head widths 112 and 128
    (their scale rounds in bf16), and S under one block."""
    B, S, H, G, hd, hd_v, causal, window, qb, kb = FLASH_CASES[case]
    q, k, v = _qkv_inputs(B, S, H, G, hd, hd_v, seed=len(case))
    want = _ref_flash(q, k, v, causal, window, qb, kb)
    got = attention.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                                    q_block=qb, kv_block=kb)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, hd_v)
    _bf16_close(want, got, ATTN_SHARE)


def test_flash_skips_only_blocks_that_change_nothing():
    """A window narrower than a block leaves kv blocks wholly masked for a
    q block, before and after its live ones; the loop skips them and the
    result is the reference's all the same (the rows that see only masked
    keys in an early block are cleared by the next live block)."""
    assert not attention._block_live(64, 96, 0, 32, 128, True, 20)
    assert not attention._block_live(0, 32, 64, 96, 128, True, 0)
    assert not attention._block_live(0, 32, 128, 160, 100, False, 0)
    assert attention._block_live(64, 96, 32, 64, 128, True, 40)
    B, S, H, G, hd, hd_v, causal, window, qb, kb = 1, 128, 4, 2, 32, 32, True, 20, 32, 32
    q, k, v = _qkv_inputs(B, S, H, G, hd, hd_v, seed=11)
    want = _ref_flash(q, k, v, causal, window, qb, kb)
    got = attention.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                                    q_block=qb, kv_block=kb)
    _bf16_close(want, got, ATTN_SHARE)


@pytest.mark.parametrize("causal, window", [(True, 0), (False, 0), (True, 40)])
def test_dense_attention_matches_reference(causal, window):
    q, k, v = _qkv_inputs(2, 100, 4, 2, 32, 32, seed=3)
    want = jax.jit(lambda q, k, v: ref_attention.dense_attention(
        q, k, v, causal=causal, window=window))(q, k, v)
    got = attention.dense_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 100, 4, 32)
    _bf16_close(want, got, ATTN_SHARE)


def test_attn_impl_dense_selects_the_dense_variant():
    _, cfg = _pair("repro_gpt_100m")
    q, k, v = (_t(a) for a in _qkv_inputs(1, 50, 4, 2, 32, 32, seed=4))
    dense = dataclasses.replace(cfg, attn_impl="dense")
    assert torch.equal(attention._attend(q, k, v, dense, causal=True),
                       attention.dense_attention(q, k, v, causal=True))
    assert torch.equal(attention._attend(q, k, v, cfg, causal=True),
                       attention.flash_attention(q, k, v, causal=True, q_block=64, kv_block=64))


def _p_f32(q, k, v, causal, window, qb, kb):
    """The flash loop with ``v`` in f32, so ``p.to(v.dtype)`` leaves ``p``
    unrounded before the PV product."""
    return attention.flash_attention(q, k, v.float(), causal=causal, window=window,
                                     q_block=qb, kv_block=kb)


def _dense(q, k, v, causal, window, qb, kb):
    return attention.dense_attention(q, k, v, causal=causal, window=window)


def _flash(q, k, v, causal, window, qb, kb):
    return attention.flash_attention(q, k, v, causal=causal, window=window,
                                     q_block=qb, kv_block=kb)


@pytest.mark.parametrize("control", ["p_f32", "dense_softmax", "scale_f32"])
def test_bf16_controls_exceed_the_limit(monkeypatch, control):
    """Each control differs from the reference flash loop on far more than
    ``ATTN_SHARE`` of entries, so the limit catches a missed cast: ``p``
    left in f32, a dense softmax in place of the flash loop, and the scale
    ``hd ** -0.5`` not rounded to bf16."""
    B, S, H, G, hd, hd_v, causal, window, qb, kb = FLASH_CASES["causal"]
    q, k, v = _qkv_inputs(B, S, H, G, hd, hd_v, seed=len("causal"))
    want = _f32(_ref_flash(q, k, v, causal, window, qb, kb))
    if control == "scale_f32":
        monkeypatch.setattr(attention, "_bf16_scale", lambda hd: hd ** -0.5)
    fn = {"p_f32": _p_f32, "dense_softmax": _dense, "scale_f32": _flash}[control]
    got = fn(_t(q), _t(k), _t(v), causal, window, qb, kb)
    differ = float((np.abs(want - got.float().numpy()) > 0).mean())
    assert differ > 10 * ATTN_SHARE, differ


# -- projections and attention over a sequence -------------------------------

def _positions(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()


@pytest.mark.parametrize("name", ["repro_gpt_100m", "granite_20b", "h2o_danube3_4b"])
def test_qkv_and_gqa_train_match_reference(name):
    """RoPE at (B, S) positions (repro_gpt, h2o), QKV bias and no RoPE
    (granite: MQA, learned positions elsewhere): q, k, v and the
    attention output within the bf16 rule (the output at ``ROW_SHARE``)."""
    jcfg, cfg = _pair(name)
    p = _layer(jcfg, "layers", ("attn",), seed=1)
    B, S = 2, 100
    x = (np.random.default_rng(2).standard_normal((B, S, cfg.d_model))).astype(BF16)
    pos = _positions(B, S)
    tp = convert.params_from_numpy(p, device="cpu")
    want = jax.jit(lambda p, x: ref_attention._qkv(p, x, jcfg, jnp.asarray(pos)))(p, x)
    got = attention._qkv(tp, _t(x), cfg, torch.from_numpy(pos))
    for w, g in zip(want, got):
        _bf16_close(w, g, ATTN_SHARE)
    want = jax.jit(lambda p, x: ref_attention.gqa_train(p, x, jcfg, jnp.asarray(pos)))(p, x)
    got = attention.gqa_train(tp, _t(x), cfg, torch.from_numpy(pos))
    assert got.shape == (B, S, cfg.d_model)
    _bf16_close(want, got, ROW_SHARE)


def test_mrope_positions_raise():
    """M-RoPE over ``pos_thw`` (reduced qwen2_vl with sections (4, 6, 6), so
    the h and w sections act at ``hd`` 32): q, k, v and the attention
    output within the bf16 rule, as the RoPE cases above; a ``pos_thw``
    given to a config without M-RoPE is ignored, as in the reference."""
    jcfg, cfg = (dataclasses.replace(c, mrope_sections=(4, 6, 6))
                 for c in _pair("qwen2_vl_2b"))
    p = _layer(jcfg, "layers", ("attn",), seed=7)
    B, S = 2, 100
    x = (np.random.default_rng(8).standard_normal((B, S, cfg.d_model))).astype(BF16)
    pos = _positions(B, S)
    rng = np.random.default_rng(9)
    thw = np.stack([np.zeros((B, S)), rng.integers(0, 12, (B, S)),
                    rng.integers(0, 12, (B, S))], -1).astype(np.int32)
    tp = convert.params_from_numpy(p, device="cpu")
    want = jax.jit(lambda p, x: ref_attention._qkv(p, x, jcfg, jnp.asarray(pos), thw))(p, x)
    got = attention._qkv(tp, _t(x), cfg, torch.from_numpy(pos), torch.from_numpy(thw))
    for w, g in zip(want, got):
        _bf16_close(w, g, ATTN_SHARE)
    want = jax.jit(lambda p, x: ref_attention.gqa_train(p, x, jcfg, jnp.asarray(pos), thw))(p, x)
    got = attention.gqa_train(tp, _t(x), cfg, torch.from_numpy(pos), torch.from_numpy(thw))
    _bf16_close(want, got, ROW_SHARE)
    gcfg = _pair("repro_gpt_100m")[1]
    gp = convert.params_from_numpy(_layer(_pair("repro_gpt_100m")[0], "layers", ("attn",)),
                                   device="cpu")
    xg = _t(x)[..., :gcfg.d_model]
    assert torch.equal(attention.gqa_train(gp, xg, gcfg, torch.from_numpy(pos),
                                           pos_thw=torch.from_numpy(thw)),
                       attention.gqa_train(gp, xg, gcfg, torch.from_numpy(pos)))


@pytest.mark.parametrize("key", ["dense_layers", "moe_layers"])
def test_mla_qkv_and_mla_train_match_reference(key):
    """q_norm / kv_norm, the shared rope key broadcast to every head,
    192/128-style widths (48 against 32 reduced): the five tensors and
    the attention output within the bf16 rule (the output at
    ``ROW_SHARE``)."""
    jcfg, cfg = _pair("deepseek_v2_236b")
    p = _layer(jcfg, key, ("attn",), seed=5)
    B, S = 2, 100
    x = (np.random.default_rng(6).standard_normal((B, S, cfg.d_model))).astype(BF16)
    pos = _positions(B, S)
    tp = convert.params_from_numpy(p, device="cpu")
    want = jax.jit(lambda p, x: ref_attention._mla_qkv(p, x, jcfg, jnp.asarray(pos)))(p, x)
    got = attention._mla_qkv(tp, _t(x), cfg, torch.from_numpy(pos))
    H = cfg.n_heads
    shapes = [(B, S, H, 48), (B, S, H, 48), (B, S, H, 32), (B, S, 16), (B, S, 1, 16)]
    for w, g, shape in zip(want, got, shapes):
        assert tuple(g.shape) == shape
        _bf16_close(w, g, ATTN_SHARE)
    want = jax.jit(lambda p, x: ref_attention.mla_train(p, x, jcfg, jnp.asarray(pos)))(p, x)
    got = attention.mla_train(tp, _t(x), cfg, torch.from_numpy(pos))
    _bf16_close(want, got, ROW_SHARE)


# -- SSM ---------------------------------------------------------------------

def test_causal_conv_matches_reference():
    jcfg, cfg = _pair("mamba2_130m")
    conv = _layer(jcfg, "layers", ("mamba", "conv"), seed=7)
    rng = np.random.default_rng(8)
    conv["b"] = (rng.standard_normal(conv["b"].shape) * 0.1).astype(BF16)
    u = rng.standard_normal((2, 100, conv["w"].shape[1])).astype(BF16)
    want = jax.jit(ref_ssm._causal_conv)(conv, u)
    got = ssm._causal_conv(convert.params_from_numpy(conv, device="cpu"), _t(u))
    assert torch.equal(got, _t(want))


@pytest.mark.parametrize("S, chunk", [(100, 32), (64, 32), (20, 32)])
def test_ssd_scan_matches_reference(S, chunk):
    """S not a multiple of the chunk (padded), a whole number of chunks,
    and S under one chunk (Q = S)."""
    B, H, P, N = 2, 4, 32, 16
    rng = np.random.default_rng(S)
    xh = rng.standard_normal((B, S, H, P)).astype(BF16)
    dt = (np.abs(rng.standard_normal((B, S, H))) * 0.5).astype(np.float32)
    A = -np.abs(rng.standard_normal(H)).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(BF16)
    Cc = rng.standard_normal((B, S, N)).astype(BF16)
    D = rng.standard_normal(H).astype(np.float32)
    want = jax.jit(lambda *a: ref_ssm.ssd_scan(*a, chunk))(xh, dt, A, Bc, Cc, D)
    got = ssm.ssd_scan(_t(xh), torch.from_numpy(dt), torch.from_numpy(A), _t(Bc), _t(Cc),
                       torch.from_numpy(D), chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, P)
    assert torch.isfinite(got.float()).all()
    _bf16_close(want, got, SSD_SHARE)


def test_mamba2_train_matches_reference():
    jcfg, cfg = _pair("mamba2_130m")
    p = _layer(jcfg, "layers", ("mamba",), seed=9)
    x = np.random.default_rng(10).standard_normal((2, 100, cfg.d_model)).astype(BF16)
    want = jax.jit(lambda p, x: ref_ssm.mamba2_train(p, x, jcfg))(p, x)
    got = ssm.mamba2_train(convert.params_from_numpy(p, device="cpu"), _t(x), cfg)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _bf16_close(want, got, SSD_SHARE)


# -- MoE ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["olmoe_1b_7b", "deepseek_v2_236b"])
def test_moe_apply_drops_tokens_as_the_reference(name):
    """At the config's capacity factor (1.25) with 200 tokens a shard:
    every token shares one direction, so the router sends most of them to
    the same experts and their groups overflow C.  The dispatch drops
    exactly the reference's pairs; ``y`` and ``aux`` match."""
    jcfg, cfg = _pair(name)
    assert cfg.capacity_factor == 1.25
    p = _layer(jcfg, "moe_layers", ("moe",), seed=12)
    rng = np.random.default_rng(13)
    common = rng.standard_normal(cfg.d_model)
    x = (common + 0.5 * rng.standard_normal((2, 100, cfg.d_model))).astype(BF16)
    want, want_aux = jax.jit(lambda p, x: ref_moe.moe_apply(p, x, jcfg))(p, x)
    tp = convert.params_from_numpy(p, device="cpu")
    got, aux = moe.moe_apply(tp, _t(x), cfg)
    # the reference's dispatch on the same routing
    xt = jnp.asarray(x).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jnp.asarray(p["router"]["w"]), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.experts_per_token)
    C = moe.capacity(cfg, 200)
    _, ref_sort, ref_pos = ref_moe._dispatch_one(xt, idx, C, cfg.n_experts)
    _, _, pidx = moe.route(tp, _t(x).reshape(-1, cfg.d_model), cfg)
    _, sort, pos = moe.dispatch(_t(x).reshape(-1, cfg.d_model), pidx, C, cfg.n_experts)
    assert np.array_equal(pidx.numpy(), np.asarray(idx))
    assert np.array_equal(sort.numpy(), np.asarray(ref_sort))
    assert np.array_equal(pos.numpy(), np.asarray(ref_pos))
    assert (pos < 0).sum() > 0, "no token was dropped"
    want = _f32(want)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert np.abs(got.float().numpy() - want).max() <= REL_TOL * np.abs(want).max()
    assert aux.dtype == torch.float32 and abs(float(aux) - float(want_aux)) <= 1e-6
