"""The MoE family — ``olmoe_1b_7b`` and ``deepseek_v2_236b`` — in the port
against the reference, at ``reduced()`` size.

Between them they run every code path of the family: the f32 router,
top-k with the reference's tie order, the sorted capacity dispatch with
dropped tokens, the combine, shared experts, a leading ``dense_layers``
stack, and MLA attention with its latent cache (deepseek).

Weights come from a numpy seed (``standard_normal * 0.02`` per leaf of the
reference's tree, the router in f32) and cross to the port with
``convert.params_from_numpy`` bit for bit.  The limit is
``tests/test_torch_model.py``'s: 1e-4 of the largest logit (and of the
largest cache entry), with the same greedy tokens; the RoPE keys in the
caches within one bf16 step (see ``_teacher_forced``).  The dispatch
(``idx``, ``sort``, ``pos``) must be exactly the reference's.
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
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.serve.step import greedy_generate as ref_greedy_generate
from repro_torch import _util, convert
from repro_torch.configs import get_config
from repro_torch.models import attention, decode_step, init_decode_state, moe
from repro_torch.models.model import cache_keys, init_params, param_dtypes, param_shapes
from repro_torch.serve import greedy_generate

REL_TOL = 1e-4
ARCHS = ["olmoe_1b_7b", "deepseek_v2_236b"]
SERVED = ["repro_gpt_100m", "granite_20b", "qwen15_4b", "yi_6b", "h2o_danube3_4b"] + ARCHS


def _pair(name, **override):
    jcfg = ref_get_config(name).reduced()
    cfg = get_config(name).reduced()
    if override:
        jcfg = dataclasses.replace(jcfg, **override)
        cfg = dataclasses.replace(cfg, **override)
    return jcfg, cfg


def _params(jcfg, seed=0):
    model = build_model(jcfg)
    leaves, treedef = jax.tree_util.tree_flatten(model.abstract_params())
    rng = np.random.default_rng(seed)
    np_leaves = [(rng.standard_normal(l.shape) * 0.02).astype(np.dtype(l.dtype)) for l in leaves]
    nptree = jax.tree_util.tree_unflatten(treedef, np_leaves)
    return model, jax.tree_util.tree_map(jnp.asarray, nptree), nptree


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _leaves(node):
    if isinstance(node, dict):                   # shapes and dtypes are the leaves here
        return [s for k in sorted(node) for s in _leaves(node[k])]
    return [node]


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference_field_by_field(name, reduced):
    a, b = ref_get_config(name), get_config(name)
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert _fields(a) == _fields(b)


@pytest.mark.parametrize("name", SERVED)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_shapes_and_dtypes_match_reference(name, reduced):
    jcfg, cfg = ref_get_config(name), get_config(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    abstract = jax.tree_util.tree_leaves(build_model(jcfg).abstract_params())
    assert _leaves(param_shapes(cfg)) == [tuple(l.shape) for l in abstract]
    assert [_util.dtype_name(d) for d in _leaves(param_dtypes(cfg))] == [
        str(l.dtype) for l in abstract]
    assert sorted(param_shapes(cfg)) == sorted(build_model(jcfg).abstract_params())


def _nbytes(shapes, dtypes):
    return sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size()
               for s, d in zip(_leaves(shapes), _leaves(dtypes)))


def test_published_sizes():
    """olmoe whole: 13,842,386,944 B (839,393,280 a layer, routers f32);
    deepseek's dense layer, MoE layer, embedding and head at its widths."""
    cfg = get_config("olmoe_1b_7b")
    shapes, dtypes = param_shapes(cfg), param_dtypes(cfg)
    assert _nbytes(shapes, dtypes) == 13_842_386_944
    assert _nbytes(shapes["moe_layers"], dtypes["moe_layers"]) == 16 * 839_393_280
    assert shapes["moe_layers"]["moe"]["experts"]["w_gate"] == (16, 64, 2048, 1024)
    assert dtypes["moe_layers"]["moe"]["router"]["w"] == torch.float32
    ds = dataclasses.replace(get_config("deepseek_v2_236b"), n_layers=2)
    shapes, dtypes = param_shapes(ds), param_dtypes(ds)
    assert _nbytes(shapes["dense_layers"], dtypes["dense_layers"]) == 675_962_880
    assert _nbytes(shapes["moe_layers"], dtypes["moe_layers"]) == 7_945_871_360
    assert _nbytes({k: shapes[k] for k in ("embed", "lm_head")},
                   {k: dtypes[k] for k in ("embed", "lm_head")}) == 2_097_152_000
    assert _nbytes(shapes, dtypes) == 10_718_996_480         # with the final norm
    assert shapes["moe_layers"]["moe"]["experts"]["w_gate"] == (1, 160, 5120, 1536)
    assert shapes["moe_layers"]["moe"]["shared"]["w_gate"] == (1, 5120, 3072)


def test_params_from_numpy_carries_the_f32_router_bit_for_bit():
    jcfg, cfg = _pair("olmoe_1b_7b")
    _, _, nptree = _params(jcfg)
    want = nptree["moe_layers"]["moe"]["router"]["w"]
    assert want.dtype == np.float32
    want = want.copy()
    want.reshape(-1)[:4] = [np.float32(1e-45), -0.0, np.float32(3.4e38), np.nan]
    got = convert.params_from_numpy({"w": want}, device="cpu")["w"]
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    tree = convert.params_from_numpy(nptree, device="cpu")
    assert tree["moe_layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert tree["moe_layers"]["moe"]["experts"]["w_up"].dtype == torch.bfloat16


def test_init_params_draws_the_router_in_f32():
    cfg = get_config("deepseek_v2_236b").reduced()
    params = init_params(cfg, 0, device="cpu")
    assert params["moe_layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert [tuple(t.shape) for t in _util.tree_leaves(params)] == _leaves(param_shapes(cfg))
    assert [t.dtype for t in _util.tree_leaves(params)] == _leaves(param_dtypes(cfg))


# -- the MoE layer ------------------------------------------------------------

def _moe_inputs(jcfg, B, seed, same_rows=False):
    model, jparams, nptree = _params(jcfg)
    layer = jax.tree_util.tree_map(lambda a: a[0], nptree["moe_layers"]["moe"])
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    if same_rows:
        x[:] = x[0]
    return layer, x.astype(jnp.bfloat16.dtype)


@jax.jit
def _ref_route(p, xt):
    probs = jax.nn.softmax(ref_layers.dense(p["router"], xt, compute_dtype=jnp.float32), axis=-1)
    return probs


def _ref_dispatch(jcfg, layer, x):
    """The reference's own lines of ``moe_apply`` up to the dispatch, one
    shard: (gate, idx, sort, pos, C)."""
    xt = jnp.asarray(x).reshape(-1, jcfg.d_model)
    K, E = jcfg.experts_per_token, jcfg.n_experts
    gate, idx = jax.lax.top_k(_ref_route(jax.tree_util.tree_map(jnp.asarray, layer), xt), K)
    gate = gate / jnp.maximum(jnp.sum(gate, axis=-1, keepdims=True), 1e-9)
    C = int(xt.shape[0] * K / E * jcfg.capacity_factor) + 1
    _, sort, pos = ref_moe._dispatch_one(xt, idx, C, E)
    return np.asarray(gate), np.asarray(idx), np.asarray(sort), np.asarray(pos), C


def _port_dispatch(cfg, layer, x):
    p = convert.params_from_numpy(layer, device="cpu")
    xt = convert.params_from_numpy({"x": x}, device="cpu")["x"].reshape(-1, cfg.d_model)
    _, gate, idx = moe.route(p, xt, cfg)
    C = moe.capacity(cfg, xt.shape[0])
    _, sort, pos = moe.dispatch(xt, idx, C, cfg.n_experts)
    return gate.numpy(), idx.numpy(), sort.numpy(), pos.numpy(), C


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("B, same_rows", [(4, False), (2, False), (2, True), (16, False)])
def test_moe_dispatch_and_output_match_reference(name, B, same_rows):
    """``idx``, ``sort`` and ``pos`` exactly the reference's, ``y`` within
    ``REL_TOL`` of its largest value (the reference jitted, as its decode
    step runs it: eager, it rounds each op's bf16 result where the
    compiled step keeps f32), the aux loss within 1e-6.  At B=2, C = 1: tokens that share an
    expert are dropped (every second one when all rows are equal)."""
    jcfg, cfg = _pair(name)
    layer, x = _moe_inputs(jcfg, B, seed=B + same_rows, same_rows=same_rows)
    rg, ri, rs, rp, rc = _ref_dispatch(jcfg, layer, x)
    pg, pi, ps, pp, pc = _port_dispatch(cfg, layer, x)
    assert pc == rc and (B != 2 or pc == 1)
    assert np.array_equal(pi, ri) and np.array_equal(ps, rs) and np.array_equal(pp, rp)
    assert np.abs(pg - rg).max() <= 1e-6
    if same_rows:
        assert (pp == -1).sum() == B * cfg.experts_per_token // 2
    want, want_aux = jax.jit(lambda p, x: ref_moe.moe_apply(p, x, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, layer), jnp.asarray(x))
    want = np.asarray(want).astype(np.float32)
    got, aux = moe.moe_apply(convert.params_from_numpy(layer, device="cpu"),
                             convert.params_from_numpy({"x": x}, device="cpu")["x"], cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 1, cfg.d_model)
    assert np.abs(got.float().numpy() - want).max() <= REL_TOL * np.abs(want).max()
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("name", ARCHS)
def test_zero_router_gives_the_reference_tie_order(name):
    """All probabilities equal: experts 0..K-1 for every token, and with
    C = 1 only the first token keeps each slot."""
    jcfg, cfg = _pair(name)
    layer, x = _moe_inputs(jcfg, 2, seed=7)
    layer["router"]["w"] = np.zeros_like(layer["router"]["w"])
    rg, ri, rs, rp, _ = _ref_dispatch(jcfg, layer, x)
    pg, pi, ps, pp, pc = _port_dispatch(cfg, layer, x)
    K = cfg.experts_per_token
    assert pc == 1
    assert np.array_equal(pi, np.tile(np.arange(K), (2, 1))) and np.array_equal(pi, ri)
    assert np.array_equal(ps, rs) and np.array_equal(pp, rp)
    assert np.array_equal(pg, rg) and np.all(pg == 1.0 / K)
    # sorted pairs: (token 0, expert k) then (token 1, expert k) for each k
    assert pp.tolist() == [0, -1] * K


# -- MLA ----------------------------------------------------------------------

@pytest.mark.parametrize("pos, length", [(0, 8), (5, 8), (11, 8)])
def test_mla_decode_matches_reference(pos, length):
    """One absorbed-matmul step from random filled latent caches: at the
    start, mid-cache, and past the ring's wrap (slot ``pos % L`` masked)."""
    jcfg, cfg = _pair("deepseek_v2_236b")
    _, _, nptree = _params(jcfg, seed=3)
    p = jax.tree_util.tree_map(lambda a: a[0], nptree["moe_layers"]["attn"])
    rng = np.random.default_rng(pos)
    B = 3
    x = (rng.standard_normal((B, 1, cfg.d_model))).astype(jnp.bfloat16.dtype)
    ckv = rng.standard_normal((B, length, cfg.kv_lora_rank)).astype(jnp.bfloat16.dtype)
    kr = rng.standard_normal((B, length, cfg.qk_rope_dim)).astype(jnp.bfloat16.dtype)
    fn = jax.jit(lambda p, x, a, b, s: ref_attention.mla_decode(p, x, a, b, s, jcfg))
    want = fn(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(ckv),
              jnp.asarray(kr), jnp.asarray(pos, jnp.int32))
    t = convert.params_from_numpy({"p": p, "x": x, "a": ckv, "b": kr}, device="cpu")
    got = attention.mla_decode(t["p"], t["x"], t["a"], t["b"],
                               torch.tensor(pos, dtype=torch.int32), cfg)
    for g, w, shape in zip(got, want, [(B, 1, cfg.d_model), (B, 1, cfg.kv_lora_rank),
                                        (B, 1, cfg.qk_rope_dim)]):
        w = np.asarray(w).astype(np.float32)
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == shape == w.shape
        assert np.abs(g.float().numpy() - w).max() <= REL_TOL * np.abs(w).max()


def test_init_mla_cache_shapes():
    cfg = get_config("deepseek_v2_236b")
    c = attention.init_mla_cache(cfg, 4, 336, 2, "cpu")
    assert c["c_kv"].shape == (2, 4, 336, 512) and c["k_rope"].shape == (2, 4, 336, 64)
    assert c["c_kv"].dtype == c["k_rope"].dtype == torch.bfloat16
    state = init_decode_state(cfg.reduced(), 2, 7, start_pos=0, device="cpu")
    assert sorted(state) == ["mla_ckv", "mla_kr", "pos"]
    assert cache_keys(cfg) == ("mla_ckv", "mla_kr")


# -- the whole model ----------------------------------------------------------

def _bf16_ulps(a, b):
    """Per entry, how many bf16 steps apart two bf16 arrays are (int16 bits;
    entries of one sign, as the caches here are compared)."""
    a = np.asarray(a).view(np.int16).astype(np.int32)
    b = np.asarray(b).view(np.int16).astype(np.int32)
    return np.abs(a - b)


def _teacher_forced(jcfg, cfg, steps, B=2, seed=0):
    """Port vs reference ``decode_step`` on the same tokens, each step from
    the reference's state (crossed bit for bit): the largest logit gap over
    the largest logit, the same for the cache without RoPE (``kv_v`` /
    ``mla_ckv``), the largest step in bf16 ulps and the share of entries
    that differ in the cache with RoPE (``kv_k`` / ``mla_kr``), and whether
    every step's argmax agreed.

    The RoPE keys are held to one bf16 step on at most 1% of entries:
    XLA's f32 ``sin``/``cos`` on the CPU and PyTorch's round some angles to
    different last bits, so now and then a rotated key rounds to the other
    bf16 neighbour (``ROADMAP.md`` §3).  Neither is correctly rounded, so
    the port keeps ``torch.sin``/``torch.cos``."""
    model, jparams, nptree = _params(jcfg, seed)
    params = convert.params_from_numpy(nptree, device="cpu")
    jstep = jax.jit(model.decode_step)
    sa = model.init_decode_state(B, steps, start_pos=0)
    roped, plain = ("mla_kr", "mla_ckv") if cfg.mla else ("kv_k", "kv_v")
    assert sorted(sa) == sorted(cache_keys(cfg) + ("pos",))
    toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (steps, B, 1))
    gaps = {"logit": 0.0, "cache": 0.0, "rope_ulps": 0, "rope_share": 0.0}
    argmax_equal = True
    for t in toks.astype(np.int32):
        sb = convert.params_from_numpy({k: np.asarray(v) for k, v in sa.items()}, device="cpu")
        la, sa = jstep(jparams, sa, jnp.asarray(t))
        lb, sb = decode_step(cfg, params, sb, torch.from_numpy(t))
        la, lb = np.asarray(la), lb.numpy()
        assert lb.dtype == np.float32 and lb.shape == la.shape == (B, 1, cfg.vocab_size)
        assert np.isfinite(lb).all()
        gaps["logit"] = max(gaps["logit"], float(np.abs(la - lb).max() / np.abs(la).max()))
        argmax_equal &= bool(np.array_equal(la.argmax(-1), lb.argmax(-1)))
        a = np.asarray(sa[plain]).astype(np.float32)
        gaps["cache"] = max(gaps["cache"],
                            float(np.abs(a - sb[plain].float().numpy()).max() / np.abs(a).max()))
        ulps = _bf16_ulps(sa[roped], sb[roped].view(torch.int16).numpy())
        gaps["rope_ulps"] = max(gaps["rope_ulps"], int(ulps.max()))
        gaps["rope_share"] = max(gaps["rope_share"], float((ulps > 0).mean()))
        assert int(sb["pos"]) == int(sa["pos"])
    return gaps, argmax_equal


def _within(gaps):
    return (gaps["logit"] <= REL_TOL and gaps["cache"] <= REL_TOL
            and gaps["rope_ulps"] <= 1 and gaps["rope_share"] <= 0.01)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_matches_reference_teacher_forced(name):
    jcfg, cfg = _pair(name)
    gaps, argmax_equal = _teacher_forced(jcfg, cfg, steps=5)
    assert _within(gaps), gaps
    assert argmax_equal


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_generate_gives_the_reference_tokens(name):
    jcfg, cfg = _pair(name)
    model, jparams, nptree = _params(jcfg)
    params = convert.params_from_numpy(nptree, device="cpu")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    want, _ = ref_greedy_generate(model, jparams, jnp.asarray(prompt), 6)
    got, state = greedy_generate(cfg, params, torch.from_numpy(prompt), 6)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert int(state["pos"]) == 10


def test_deepseek_two_leading_dense_layers():
    """``first_k_dense`` = 2 of 3 layers: two dense layers, then MoE, one
    stacked cache split across both stacks."""
    jcfg, cfg = _pair("deepseek_v2_236b", n_layers=3, first_k_dense=2)
    assert param_shapes(cfg)["dense_layers"]["mlp"]["w_gate"] == (2, 128, 256)
    gaps, argmax_equal = _teacher_forced(jcfg, cfg, steps=3)
    assert _within(gaps), gaps
    assert argmax_equal


def test_olmoe_with_a_shared_expert_and_two_dispatch_shards():
    """The shared-expert path without MLA, and tokens routed in two
    dispatch shards of their own capacity."""
    jcfg, cfg = _pair("olmoe_1b_7b", n_shared_experts=1, dispatch_shards=2)
    gaps, argmax_equal = _teacher_forced(jcfg, cfg, steps=3, B=4)
    assert _within(gaps), gaps
    assert argmax_equal
