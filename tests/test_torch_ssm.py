"""The SSM and hybrid families — ``mamba2_130m`` and ``zamba2_7b`` — in the
port against the reference, at ``reduced()`` size.

Between them they run every decode path of the two families: the Mamba2
recurrence (``models/ssm.py``) with its f32 ``A_log`` / ``D`` /
``dt_bias`` leaves, the ``layers`` stack of the SSM family, and the hybrid
family's ``mamba_groups``, the ``shared_attn`` block applied once a group
with that group's KV cache, its sliding window, and the ``mamba_tail``
(reached with ``n_layers=5``: reduced ``zamba2_7b`` has 4 layers, two
groups of two and no tail).

Weights come from a numpy seed (``standard_normal * 0.02`` per leaf of the
reference's tree, the ``ssm`` leaves in f32) and cross to the port with
``convert.params_from_numpy`` bit for bit.  The reference runs jitted, as
its decode step runs.  Limits:

* logits within ``REL_TOL`` (1e-4) of the largest, with the same greedy
  tokens (``tests/test_torch_model.py``);
* the shared block's KV caches (bf16) within one bf16 step on at most 1% of
  entries: their new entries are bf16 products, which round to the other
  neighbour now and then for the same reason as ``ssm_conv``'s new row
  (below) — at position 74 of the window-wrap test one ``kv_v`` entry,
  1.1e-4 of the largest;
* ``ssm_state`` (f32) within ``STATE_REL_TOL`` (1e-5) of its largest entry.
  XLA on the CPU contracts the update ``state * dA + x * (dt * B)`` into
  one FMA, and its f32 ``exp`` / ``log1p`` differ from PyTorch's in the
  last bit, so about a third of the state's entries differ by an ulp
  (~1e-7 of the largest); where a bf16 input of the step rounded to its
  other neighbour (``ssm_conv``'s new row, below) the state reads more:
  1.13e-6 at position 76 of the window-wrap test;
* ``ssm_conv`` (bf16): the history it shifts along is exact; its new row
  is the bf16 rounding of ``in_proj``'s f32 product, whose 128-term sum
  runs in another order in XLA's dot, so now and then it rounds to the
  other bf16 neighbour: within one bf16 step on at most 1% of entries.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:                 # the card's machine has no JAX: only the ``gpu`` tests run there
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models import blocks as ref_blocks
    from repro.models import build_model
    from repro.models import ssm as ref_ssm
    from repro.serve.step import greedy_generate as ref_greedy_generate
except ImportError:
    jax = None
from repro_torch import _util, convert
from repro_torch.configs import get_config
from repro_torch.models import blocks, decode_step, init_decode_state, ssm
from repro_torch.models.model import (
    cache_keys, cache_len, hybrid_groups, init_params, layer_plan, param_dtypes, param_shapes,
)
from repro_torch.serve import greedy_generate, make_serve_step

REL_TOL = 1e-4
STATE_REL_TOL = 1e-5
ARCHS = ["mamba2_130m", "zamba2_7b"]
# (name, n_layers override): the hybrid with a tail as well
CASES = [("mamba2_130m", None), ("zamba2_7b", None), ("zamba2_7b", 5)]
CASE_IDS = ["mamba2_130m", "zamba2_7b", "zamba2_7b-tail"]
ALL_ARCHS = ["repro_gpt_100m", "granite_20b", "qwen15_4b", "yi_6b", "h2o_danube3_4b",
             "olmoe_1b_7b", "deepseek_v2_236b"] + ARCHS


def _pair(name, n_layers=None):
    jcfg = ref_get_config(name).reduced()
    cfg = get_config(name).reduced()
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
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


def _np(t):
    """A port tensor as the reference's numpy array, bit for bit."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16.dtype)
    return t.numpy()


def _rel(want, got):
    want = np.asarray(want).astype(np.float32)
    return float(np.abs(want - np.asarray(got).astype(np.float32)).max() / np.abs(want).max())


def _bf16_within(want, got):
    """Two bf16 arrays within one bf16 step on at most 1% of entries;
    returns the share that differ."""
    a = np.asarray(want).view(np.int16).astype(np.int32)
    b = np.asarray(got).view(np.int16).astype(np.int32)
    assert a.shape == b.shape
    ulps = np.abs(a - b)
    assert ulps.max() <= 1
    share = float((ulps > 0).mean())
    assert share <= 0.01, share
    return share


def _conv_within(want, got, old=None):
    """``ssm_conv`` against the reference's: rows that shift along the
    history exact; the new row within one bf16 step on at most 1% of
    entries.  Returns the share of new-row entries that differ."""
    a = np.asarray(want).view(np.int16).astype(np.int32)
    b = np.asarray(got).view(np.int16).astype(np.int32)
    assert a.shape == b.shape
    assert np.array_equal(a[..., :-1, :], b[..., :-1, :])
    if old is not None:                          # the shift itself: old rows 1.. move up
        o = np.asarray(old).view(np.int16).astype(np.int32)
        assert np.array_equal(b[..., :-1, :], o[..., 1:, :])
    return _bf16_within(want[..., -1, :], got[..., -1, :])


# -- configs and params --------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference_field_by_field(name, reduced):
    a, b = ref_get_config(name), get_config(name)
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert _fields(a) == _fields(b)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_config_properties_equal_the_reference(name):
    a, b = ref_get_config(name), get_config(name)
    for c, d in ((a, b), (a.reduced(), b.reduced())):
        assert (c.is_attention_free, c.subquadratic, c.has_decode) == (
            d.is_attention_free, d.subquadratic, d.has_decode)
    assert b.is_attention_free == (name == "mamba2_130m")
    assert b.subquadratic == (name in ARCHS or name == "h2o_danube3_4b")


def test_reduced_configs_pinned():
    """The sizes the CPU tests run at: mamba2 two layers of d_inner 256 with
    8 heads of 32 and state 16; zamba2 two groups of two, no tail, a
    64-token window."""
    m = get_config("mamba2_130m").reduced()
    assert (m.n_layers, m.d_model, m.ssm_expand, m.ssm_head_dim, m.ssm_state, m.ssm_conv,
            m.vocab_size, m.n_heads, m.tie_embeddings) == (2, 128, 2, 32, 16, 4, 512, 4, False)
    z = get_config("zamba2_7b").reduced()
    assert (z.n_layers, z.shared_attn_every, z.window, z.n_heads, z.n_kv_heads, z.head_dim,
            z.d_ff, z.ssm_state) == (4, 2, 64, 4, 2, 32, 256, 16)
    assert hybrid_groups(z) == (2, 2, 0)
    assert hybrid_groups(dataclasses.replace(z, n_layers=5)) == (2, 2, 1)
    assert hybrid_groups(get_config("zamba2_7b")) == (13, 6, 3)


@pytest.mark.parametrize("name, n_layers", CASES + [("mamba2_130m", 0), ("zamba2_7b", 0)],
                         ids=CASE_IDS + ["mamba2_130m-full", "zamba2_7b-full"])
def test_param_shapes_and_dtypes_match_reference(name, n_layers):
    if n_layers == 0:                            # the published config, abstract only
        jcfg, cfg = ref_get_config(name), get_config(name)
    else:
        jcfg, cfg = _pair(name, n_layers)
    abstract = build_model(jcfg).abstract_params()
    leaves = jax.tree_util.tree_leaves(abstract)
    assert _leaves(param_shapes(cfg)) == [tuple(l.shape) for l in leaves]
    assert [_util.dtype_name(d) for d in _leaves(param_dtypes(cfg))] == [
        str(l.dtype) for l in leaves]
    assert sorted(param_shapes(cfg)) == sorted(abstract)


def _nbytes(shapes, dtypes):
    return sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size()
               for s, d in zip(_leaves(shapes), _leaves(dtypes)))


def test_published_sizes():
    """mamba2_130m whole: 335,200,512 B; zamba2_7b whole: 13,502,316,096 B,
    its stacked ``in_proj`` the first leaf over 2^32 bytes."""
    cfg = get_config("mamba2_130m")
    shapes, dtypes = param_shapes(cfg), param_dtypes(cfg)
    assert _nbytes(shapes, dtypes) == 335_200_512
    assert shapes["layers"]["mamba"]["in_proj"]["w"] == (24, 768, 3352)
    assert dtypes["layers"]["mamba"]["ssm"]["A_log"] == torch.float32
    assert shapes["layers"]["mamba"]["ssm"]["A_log"] == (24, 24)
    assert "lm_head" in shapes
    z = get_config("zamba2_7b")
    shapes, dtypes = param_shapes(z), param_dtypes(z)
    assert _nbytes(shapes, dtypes) == 13_502_316_096
    w = shapes["mamba_groups"]["mamba"]["in_proj"]["w"]
    assert w == (13, 6, 3584, 14576) and dtypes["mamba_groups"]["mamba"]["in_proj"]["w"] == (
        torch.bfloat16)
    assert int(np.prod(w)) == 4_074_749_952 and 2 * int(np.prod(w)) > 1 << 32
    assert shapes["mamba_tail"]["mamba"]["in_proj"]["w"] == (3, 3584, 14576)
    assert shapes["shared_attn"]["attn"]["wq"]["w"] == (3584, 3584)


def test_params_from_numpy_carries_the_f32_ssm_leaves_bit_for_bit():
    jcfg, _ = _pair("zamba2_7b", 5)
    _, _, nptree = _params(jcfg)
    tree = convert.params_from_numpy(nptree, device="cpu")
    for key in ("mamba_groups", "mamba_tail"):
        for leaf in ("A_log", "D", "dt_bias"):
            want = nptree[key]["mamba"]["ssm"][leaf]
            got = tree[key]["mamba"]["ssm"][leaf]
            assert want.dtype == np.float32 and got.dtype == torch.float32
            assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    odd = np.array([1e-45, -0.0, 3.4e38, np.nan, -np.inf], np.float32)
    got = convert.params_from_numpy({"A_log": odd}, device="cpu")["A_log"]
    assert np.array_equal(got.numpy().view(np.int32), odd.view(np.int32))
    assert tree["mamba_groups"]["mamba"]["in_proj"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_draws_the_ssm_leaves_in_f32(name):
    cfg = get_config(name).reduced()
    params = init_params(cfg, 0, device="cpu")
    assert [tuple(t.shape) for t in _util.tree_leaves(params)] == _leaves(param_shapes(cfg))
    assert [t.dtype for t in _util.tree_leaves(params)] == _leaves(param_dtypes(cfg))
    stack = params["layers" if name == "mamba2_130m" else "mamba_groups"]
    assert stack["mamba"]["ssm"]["D"].dtype == torch.float32
    again = init_params(cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_util.tree_leaves(params),
                                                 _util.tree_leaves(again)))


@pytest.mark.parametrize("name, n_layers", CASES, ids=CASE_IDS)
def test_init_decode_state_matches_reference(name, n_layers):
    jcfg, cfg = _pair(name, n_layers)
    want = build_model(jcfg).init_decode_state(3, 100, start_pos=0)
    got = init_decode_state(cfg, 3, 100, start_pos=0, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert _util.dtype_name(got[k].dtype) == str(want[k].dtype), k
        assert not got[k].any()
    if name == "zamba2_7b":                      # the KV cache is the window, a group each
        assert got["kv_k"].shape[:3] == (2, 3, 64) and cache_len(cfg, 100) == 64


def test_layer_plans():
    m = get_config("mamba2_130m").reduced()
    assert layer_plan(m) == [("layers", 0, "ssm"), ("layers", 1, "ssm")]
    assert cache_keys(m) == ("ssm_state", "ssm_conv")
    with pytest.raises(NotImplementedError, match="repeats"):
        layer_plan(get_config("zamba2_7b").reduced())


# -- the recurrence ------------------------------------------------------------

def _layer_inputs(jcfg, B, seed, key="layers", index=(0,)):
    """One layer of seeded params, an input, a filled state and history."""
    _, _, nptree = _params(jcfg, seed)
    lp = jax.tree_util.tree_map(lambda a: a[index], nptree[key])
    rng = np.random.default_rng(seed + 100)
    d_inner = jcfg.ssm_expand * jcfg.d_model
    H, N = d_inner // jcfg.ssm_head_dim, jcfg.ssm_state
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(jnp.bfloat16.dtype)
    state = (rng.standard_normal((B, H, jcfg.ssm_head_dim, N)) * 0.1).astype(np.float32)
    conv = (rng.standard_normal((B, jcfg.ssm_conv - 1, d_inner + 2 * N))).astype(
        jnp.bfloat16.dtype)
    return lp, x, state, conv


@pytest.mark.parametrize("B, seed", [(1, 0), (4, 1), (3, 2)])
def test_mamba2_decode_matches_reference(B, seed):
    """``mamba2_decode`` alone against the jitted reference, from a filled
    state and conv history."""
    jcfg, cfg = _pair("mamba2_130m")
    lp, x, state, conv = _layer_inputs(jcfg, B, seed)
    fn = jax.jit(lambda p, x, s, c: ref_ssm.mamba2_decode(p, x, s, c, jcfg))
    ya, sa, ca = fn(jax.tree_util.tree_map(jnp.asarray, lp["mamba"]), jnp.asarray(x),
                    jnp.asarray(state), jnp.asarray(conv))
    t = convert.params_from_numpy({"p": lp["mamba"], "x": x, "s": state, "c": conv},
                                  device="cpu")
    yb, sb, cb = ssm.mamba2_decode(t["p"], t["x"], t["s"], t["c"], cfg)
    assert yb.dtype == torch.bfloat16 and yb.shape == (B, 1, cfg.d_model)
    assert sb.dtype == torch.float32 and cb.dtype == torch.bfloat16
    assert _rel(ya, yb.float().numpy()) <= REL_TOL
    assert _rel(sa, sb.numpy()) <= STATE_REL_TOL
    _conv_within(ca, _np(cb), old=conv)


@pytest.mark.parametrize("name, key, index", [
    ("mamba2_130m", "layers", (1,)), ("zamba2_7b", "mamba_groups", (1, 0)),
    ("zamba2_7b-tail", "mamba_tail", (0,)),
])
def test_mamba_block_decode_matches_reference(name, key, index):
    """The block (norm, recurrence, residual) against the jitted
    reference's, at a layer of each stack."""
    base = name.split("-")[0]
    jcfg, cfg = _pair(base, 5 if name.endswith("tail") else None)
    lp, x, state, conv = _layer_inputs(jcfg, 2, 5, key, index)
    fn = jax.jit(lambda p, x, s, c: ref_blocks.mamba_block_decode(p, x, (s, c), 0, jcfg))
    ya, (sa, ca) = fn(jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x),
                      jnp.asarray(state), jnp.asarray(conv))
    t = convert.params_from_numpy({"p": lp, "x": x, "s": state, "c": conv}, device="cpu")
    yb, (sb, cb) = blocks.mamba_block_decode(t["p"], t["x"], (t["s"], t["c"]),
                                             torch.tensor(0, dtype=torch.int32), cfg)
    assert _rel(ya, yb.float().numpy()) <= REL_TOL
    assert _rel(sa, sb.numpy()) <= STATE_REL_TOL
    _conv_within(ca, _np(cb), old=conv)


def test_softplus_is_the_reference_formula():
    """``jax.nn.softplus``'s formula on f32 (``max(x, 0) + log1p(exp(-|x|))``,
    the compiled step's HLO), NaN and infinities included, within two ulps
    of XLA's: XLA's f32 ``exp`` / ``log1p`` on the CPU differ from
    PyTorch's in the last bit (on this grid 5.5% of values differ, by at
    most 2 ulps)."""
    x = np.concatenate([np.linspace(-40, 40, 8001, dtype=np.float32),
                        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)])
    want = np.asarray(jax.jit(jax.nn.softplus)(x))
    got = ssm.softplus_f32(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isnan(want), np.isnan(got))
    inf = np.isinf(want)
    assert np.array_equal(inf, np.isinf(got)) and np.array_equal(want[inf], got[inf])
    fin = np.isfinite(want)
    ulps = np.abs(want[fin].view(np.int32).astype(np.int64) - got[fin].view(np.int32))
    assert ulps.max() <= 2
    assert float(ssm.softplus_f32(torch.tensor([-np.inf]))) == 0.0


# -- the whole model -----------------------------------------------------------

def _from_numpy_state(state):
    return convert.params_from_numpy({k: np.asarray(v) for k, v in state.items()},
                                     device="cpu")


def _check_step(sa, sb_in, sb, la, lb):
    """One step against the reference's, each from the same state."""
    la, lb = np.asarray(la), lb.numpy()
    assert lb.dtype == np.float32 and lb.shape == la.shape and np.isfinite(lb).all()
    gaps = {"logit": _rel(la, lb), "argmax": bool(np.array_equal(la.argmax(-1), lb.argmax(-1)))}
    assert sorted(sb) == sorted(sa)
    for k in sa:
        if k == "pos":
            assert int(sb[k]) == int(sa[k])
        elif k.startswith("ssm_state"):
            gaps[k] = _rel(sa[k], sb[k].numpy())
        elif k.startswith("ssm_conv"):
            gaps[k] = _conv_within(sa[k], _np(sb[k]), old=_np(sb_in[k]))
        else:                                    # the KV caches
            gaps[k] = _bf16_within(sa[k], _np(sb[k]))
    return gaps


def _within(gaps):
    """Logits within ``REL_TOL``, SSM states within ``STATE_REL_TOL`` (the
    bf16 caches are held inside ``_check_step``)."""
    return gaps["logit"] <= REL_TOL and all(
        v <= STATE_REL_TOL for k, v in gaps.items() if k.startswith("ssm_state"))


@pytest.mark.parametrize("name, n_layers", CASES, ids=CASE_IDS)
def test_decode_step_matches_reference_teacher_forced(name, n_layers):
    """Port vs reference ``decode_step`` on the same tokens, each step from
    the reference's state crossed bit for bit: logits within ``REL_TOL``,
    the SSM state within ``STATE_REL_TOL``, the conv history and KV caches
    as ``_conv_within`` and ``_bf16_within`` hold them, the same argmax."""
    jcfg, cfg = _pair(name, n_layers)
    model, jparams, nptree = _params(jcfg)
    params = convert.params_from_numpy(nptree, device="cpu")
    jstep = jax.jit(model.decode_step)
    B, steps = 2, 6
    sa = model.init_decode_state(B, steps, start_pos=0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    for t in toks:
        sb_in = _from_numpy_state(sa)
        la, sa = jstep(jparams, sa, jnp.asarray(t))
        lb, sb = decode_step(cfg, params, sb_in, torch.from_numpy(t))
        gaps = _check_step(sa, sb_in, sb, la, lb)
        assert _within(gaps) and gaps["argmax"], gaps


def test_hybrid_window_wraps_past_twice_its_window():
    """Reduced zamba2's shared block has a 64-token window: a decode of 130
    steps wraps its ring cache twice.  Every step from position 64 on runs
    in both packages from the reference's state: logits and caches within
    their limits, and each group's new KV entries written at slot
    ``pos % 64`` alone.  Then 130 greedy tokens, free-running in each
    package, must be the same."""
    jcfg, cfg = _pair("zamba2_7b")
    assert cfg.window == 64 and cache_len(cfg, 130) == 64
    model, jparams, nptree = _params(jcfg)
    params = convert.params_from_numpy(nptree, device="cpu")
    jstep = jax.jit(model.decode_step)
    B, steps = 2, 130
    sa = model.init_decode_state(B, steps, start_pos=0)
    assert sa["kv_k"].shape[:3] == (2, B, 64)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    checked = 0
    for t in toks:
        pos = int(sa["pos"])
        sb_in = _from_numpy_state(sa) if pos >= cfg.window else None
        la, sa = jstep(jparams, sa, jnp.asarray(t))
        if sb_in is None:
            continue
        lb, sb = decode_step(cfg, params, sb_in, torch.from_numpy(t))
        gaps = _check_step(sa, sb_in, sb, la, lb)
        assert _within(gaps), (pos, str(gaps))
        for k in ("kv_k", "kv_v"):
            changed = (sb[k] != sb_in[k]).flatten(3).any(-1).any(1).any(0)
            assert changed.nonzero().flatten().tolist() == [pos % 64], (pos, k)
        checked += 1
    assert checked == steps - 64 and int(sa["pos"]) == steps > 2 * cfg.window

    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    want, _ = ref_greedy_generate(model, jparams, jnp.asarray(prompt), steps)
    got, state = greedy_generate(cfg, params, torch.from_numpy(prompt), steps)
    assert state["kv_k"].shape[2] == 64 and int(state["pos"]) == steps + 3
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("name, n_layers", CASES, ids=CASE_IDS)
def test_greedy_generate_gives_the_reference_tokens(name, n_layers):
    jcfg, cfg = _pair(name, n_layers)
    model, jparams, nptree = _params(jcfg)
    params = convert.params_from_numpy(nptree, device="cpu")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    want, wstate = ref_greedy_generate(model, jparams, jnp.asarray(prompt), 8)
    got, state = greedy_generate(cfg, params, torch.from_numpy(prompt), 8)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert int(state["pos"]) == 12 and sorted(state) == sorted(wstate)
    step = make_serve_step(cfg)
    again, _ = greedy_generate(cfg, params, torch.from_numpy(prompt), 8,
                               serve_step=lambda s, t: step(params, s, t))
    assert torch.equal(again, got)


# -- on the card (``gpu``) -----------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# Card against CPU, one step from a common state.  The two devices' f32
# sums run in other orders, so a bf16 value (a matmul output, the norm's
# result) rounds to its other neighbour now and then, and one such flip
# moves the reduced model's small logits by up to a few 1e-3 of the
# largest: on an NVIDIA H100, reduced zamba2's first step rounds one new
# ``kv_v`` entry (of the cache's 1,536) the other way and its logits read
# 2.4e-3 (all other steps of the three configs read under 3e-7; the
# CPU against XLA reads 1.4e-3 the same way at a step of reduced h2o,
# ``tests/test_torch_dense_configs.py``).  A fault in the card's path
# reads far above it.
CARD_REL_TOL = 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("name, n_layers", CASES, ids=CASE_IDS)
def test_decode_step_on_card_matches_the_cpu(cuda, name, n_layers):
    """The step on the card against the CPU's on the same params, each step
    from the CPU's state: logits and the SSM states within
    ``CARD_REL_TOL`` of their largest entry, the same argmax."""
    cfg = get_config(name).reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = init_params(cfg, 0, device="cpu")
    card = _util.tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (6, 2, 1)).astype(np.int32))
    sa = init_decode_state(cfg, 2, 6, start_pos=0, device="cpu")
    for t in toks:
        la, sa_next = decode_step(cfg, params, sa, t)
        lb, sb = decode_step(cfg, card, _util.tree_map(lambda a: a.to(cuda), sa), t.to(cuda))
        assert _rel(la.numpy(), lb.cpu().numpy()) <= CARD_REL_TOL
        assert torch.equal(la.argmax(-1), lb.argmax(-1).cpu())
        for k in sa_next:
            if k.startswith("ssm_state"):
                assert _rel(sa_next[k].numpy(), sb[k].cpu().numpy()) <= CARD_REL_TOL, k
        sa = sa_next
