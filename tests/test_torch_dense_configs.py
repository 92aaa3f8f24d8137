"""The four dense configs beside ``repro_gpt_100m`` — ``granite_20b``,
``qwen15_4b``, ``yi_6b`` and ``h2o_danube3_4b`` — in the port against the
reference, at ``reduced()`` size.

Between them they run every dense code path ``repro_gpt_100m`` leaves
out: MQA (granite's one KV head), GQA at 4 and 8 KV heads, learned
positions with the ``min(pos, max_position - 1)`` clamp, layernorm, GELU,
QKV bias, a sliding-window ring cache (h2o) and head sizes that are not a
power of two (h2o's published 120; 40 here).

Weights come from a numpy seed (``standard_normal * 0.02`` per leaf of the
reference's tree) and cross to the port with ``convert.params_from_numpy``
bit for bit.  The limit is ``tests/test_torch_model.py``'s: 1e-4 of the
largest logit (and of the largest cache entry), with the same greedy
tokens; see that file for how it was set.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model
from repro.serve.step import greedy_generate as ref_greedy_generate
from repro_torch import _util, convert
from repro_torch.configs import get_config
from repro_torch.models import decode_step, init_decode_state
from repro_torch.models.model import cache_len, init_params, param_shapes
from repro_torch.serve import greedy_generate

REL_TOL = 1e-4
ARCHS = ["granite_20b", "qwen15_4b", "yi_6b", "h2o_danube3_4b"]


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


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference_field_by_field(name, reduced):
    a, b = ref_get_config(name), get_config(name)
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert _fields(a) == _fields(b)
    assert b.dtype == torch.bfloat16


def _shapes(node):
    if isinstance(node, dict):                   # shape tuples are leaves here
        return [s for k in sorted(node) for s in _shapes(node[k])]
    return [node]


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_shapes_match_reference_tree(name, reduced):
    jcfg, cfg = ref_get_config(name), get_config(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    abstract = build_model(jcfg).abstract_params()       # eval_shape: no allocation
    want = [tuple(l.shape) for l in jax.tree_util.tree_leaves(abstract)]
    assert _shapes(param_shapes(cfg)) == want


def test_granite_published_layer_size():
    """One granite_20b layer: 15 leaves, 379,121,920 parameters."""
    shapes = param_shapes(dataclasses.replace(get_config("granite_20b"), n_layers=1))
    layer = _shapes(shapes["layers"])
    assert len(layer) == 15
    assert sum(int(np.prod(s)) for s in layer) == 379_121_920
    assert shapes["pos"]["table"] == (32768, 6144)
    assert shapes["lm_head"]["table"] == (49152, 6144)


def _teacher_forced(jcfg, cfg, steps, B=2, seed=0):
    """Port vs reference ``decode_step`` on the same tokens: the largest
    logit gap over the largest logit across steps, the same for each cache
    at the end, and whether every step's argmax agreed."""
    model, jparams, nptree = _params(jcfg, seed)
    params = convert.params_from_numpy(nptree, device="cpu")
    jstep = jax.jit(model.decode_step)
    sa = model.init_decode_state(B, steps, start_pos=0)
    sb = init_decode_state(cfg, B, steps, start_pos=0, device="cpu")
    assert sb["kv_k"].shape == tuple(sa["kv_k"].shape)
    toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (steps, B, 1))
    logit_gap, argmax_equal = 0.0, True
    for t in toks.astype(np.int32):
        la, sa = jstep(jparams, sa, jnp.asarray(t))
        lb, sb = decode_step(cfg, params, sb, torch.from_numpy(t))
        la, lb = np.asarray(la), lb.numpy()
        assert lb.dtype == np.float32 and lb.shape == la.shape == (B, 1, cfg.vocab_size)
        assert np.isfinite(lb).all()
        logit_gap = max(logit_gap, float(np.abs(la - lb).max() / np.abs(la).max()))
        argmax_equal &= bool(np.array_equal(la.argmax(-1), lb.argmax(-1)))
    assert int(sb["pos"]) == int(sa["pos"]) == steps
    kv_gap = max(
        float(np.abs(np.asarray(sa[k]).astype(np.float32) - sb[k].float().numpy()).max()
              / np.abs(np.asarray(sa[k]).astype(np.float32)).max())
        for k in ("kv_k", "kv_v")
    )
    return logit_gap, kv_gap, argmax_equal


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_matches_reference_teacher_forced(name):
    jcfg, cfg = _pair(name)
    logit_gap, kv_gap, argmax_equal = _teacher_forced(jcfg, cfg, steps=5)
    assert logit_gap <= REL_TOL and kv_gap <= REL_TOL
    assert argmax_equal


def _from_numpy_state(state):
    return convert.params_from_numpy({k: np.asarray(v) for k, v in state.items()}, device="cpu")


def test_h2o_ring_cache_wraps_past_twice_its_window():
    """h2o's reduced window is 64: a decode of 130 steps wraps the ring
    cache twice.  Every step from position 64 on runs in both packages
    from the reference's state (crossed bit for bit): logits within
    ``REL_TOL``, and the new entries written at slot ``pos % 64`` alone.  Then 130 greedy tokens, free-running in
    each package, must be the same.

    The step is held from a common state because, over a long decode,
    the two packages' f32 sums (matmuls, the norm's mean) run in another
    order and now and then round a bf16 value to its other neighbour: on
    these inputs, steps 12 and 32 (before the wrap) read 1.4e-3 and
    5.2e-4 of the largest logit that way, the size of the bf16 controls of
    ``tests/test_torch_model.py``, and a free-running decode carries such a
    flip on in its cache."""
    jcfg, cfg = _pair("h2o_danube3_4b")
    assert cfg.window == 64 and cache_len(cfg, 130) == 64
    model, jparams, nptree = _params(jcfg)
    params = convert.params_from_numpy(nptree, device="cpu")
    jstep = jax.jit(model.decode_step)
    B, steps = 2, 130
    sa = model.init_decode_state(B, steps, start_pos=0)
    assert sa["kv_k"].shape[2] == 64
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    checked = 0
    for t in toks:
        pos = int(sa["pos"])
        sb = _from_numpy_state(sa) if pos >= cfg.window else None
        la, sa = jstep(jparams, sa, jnp.asarray(t))
        if sb is None:
            continue
        lb, sb2 = decode_step(cfg, params, sb, torch.from_numpy(t))
        la = np.asarray(la)
        assert np.abs(la - lb.numpy()).max() <= REL_TOL * np.abs(la).max(), pos
        for k in ("kv_k", "kv_v"):             # the write lands on slot pos % 64 only
            changed = (sb2[k] != sb[k]).flatten(3).any(-1).any(1).any(0)
            assert changed.nonzero().flatten().tolist() == [pos % 64], (pos, k)
        checked += 1
    assert checked == steps - 64 and int(sa["pos"]) == steps > 2 * cfg.window

    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    want, _ = ref_greedy_generate(model, jparams, jnp.asarray(prompt), steps)
    got, state = greedy_generate(cfg, params, torch.from_numpy(prompt), steps)
    assert state["kv_k"].shape[2] == 64 and int(state["pos"]) == steps + 3
    assert np.array_equal(np.asarray(want), got.numpy())


def test_h2o_head_size_not_a_power_of_two():
    jcfg, cfg = _pair("h2o_danube3_4b", head_dim=40)
    assert param_shapes(cfg)["layers"]["attn"]["wq"]["w"][-1] == 4 * 40
    logit_gap, kv_gap, argmax_equal = _teacher_forced(jcfg, cfg, steps=5)
    assert logit_gap <= REL_TOL and kv_gap <= REL_TOL
    assert argmax_equal


def test_granite_learned_positions_clamp_past_the_table():
    """Positions past ``max_position - 1`` read the table's last row, as
    the reference's ``min(pos, max_position - 1)`` slice does."""
    jcfg, cfg = _pair("granite_20b", max_position=3)
    logit_gap, kv_gap, argmax_equal = _teacher_forced(jcfg, cfg, steps=6)
    assert logit_gap <= REL_TOL and kv_gap <= REL_TOL
    assert argmax_equal


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_tokens_match_reference(name):
    jcfg, cfg = _pair(name)
    model, jparams, nptree = _params(jcfg, seed=2)
    params = convert.params_from_numpy(nptree, device="cpu")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    want, _ = ref_greedy_generate(model, jparams, jnp.asarray(prompt), 4)
    got, state = greedy_generate(cfg, params, torch.from_numpy(prompt), 4)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert int(state["pos"]) == 7


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_numpy_carries_every_leaf(name):
    """``pos/table``, ``lm_head``, the ``b`` leaves and layernorm's
    ``g``/``b`` cross bit for bit, in the reference's tree."""
    jcfg, cfg = _pair(name)
    _, _, nptree = _params(jcfg)
    params = convert.params_from_numpy(nptree, device="cpu")
    flat_np = jax.tree_util.tree_flatten_with_path(nptree)[0]
    for path, a in flat_np:
        node = params
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.bfloat16 and tuple(node.shape) == a.shape
        assert np.array_equal(node.view(torch.int16).numpy(), a.view(np.int16))
    assert ("pos" in params) == (cfg.pos_embedding == "learned")
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    if cfg.norm == "layernorm":
        assert set(params["final_norm"]) == {"g", "b"}
    if cfg.qkv_bias:
        assert "b" in params["layers"]["attn"]["wq"]


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_tree_and_seed(name):
    cfg = get_config(name).reduced()
    a = init_params(cfg, seed=0, device="cpu")
    b = init_params(cfg, seed=0, device="cpu")
    c = init_params(cfg, seed=1, device="cpu")
    assert _shapes(_util.tree_map(lambda t: tuple(t.shape), a)) == _shapes(param_shapes(cfg))
    la, lb, lc = (_util.tree_leaves(x) for x in (a, b, c))
    assert all(x.dtype == torch.bfloat16 for x in la)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not all(torch.equal(x, y) for x, y in zip(la, lc))
