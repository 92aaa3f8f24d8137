"""The vlm and audio families in the port against the reference, at
``reduced()`` size: ``qwen2_vl_2b`` (M-RoPE over ``pos_thw``, a vision
front end) and ``hubert_xlarge`` (encoder-only, learned positions, an
audio front end, f32 params).

* ``apply_mrope`` against the reference's on seeded inputs for four
  section cases: qwen2_vl's (16, 24, 24) at ``hd`` 128 (an exact fit) and
  at the reduced ``hd`` 32 (cut short: every pair temporal), (2, 3, 3)
  (the last id runs on) and (4, 6, 6) (an exact fit at 32).  XLA's and
  PyTorch's f32 ``sin`` / ``cos`` differ in the last bit (``ROADMAP.md``
  §3), so the rotated entries are held as the RoPE keys are in
  ``tests/test_torch_moe.py``: one bf16 step on at most 1% of entries.
* ``gqa_train`` with ``pos_thw`` at qwen2_vl's full widths, one layer.
* The whole forward and ``make_prefill`` against the jitted reference
  ``Model.forward`` on the same exported params and the same
  ``data.make_batch`` inputs, at ``tests/test_torch_prefill.py``'s limits
  (1e-4 of the largest logit at >= 95% of rows, 2e-3 at every row), over
  the rows of the batches of steps 0-3; qwen2_vl also with
  ``mrope_sections=(4, 6, 6)``, where the h and w sections act at the
  reduced ``hd``.  ``make_batch`` seeds with ``hash(cfg.name)``, which
  Python salts per process, so these tests pin that hash in both
  pipelines (``pinned_hash``): every run holds the same batches.  With
  the hash left to the process a single batch now and then put more than
  5% of the rows above 1e-4 (a flipped bf16 activation moves its row; in
  hubert, non-causal, every row of its sequence a little), so the row
  rule is held over four batches' rows.
* The param trees (shapes and dtypes) of all 11 configs at full size, the
  parameter counts, ``list_archs`` / ``SHAPES`` / ``shape_cells``,
  ``make_batch`` / ``batch_specs``.
* Serving reduced qwen2_vl: ``decode_step`` from the reference's state,
  greedy tokens, the compressed ring and the KV tier bit-identical to the
  port's plain step, the serving entry point on the reference's
  checkpoint.  Reduced hubert: its f32 checkpoint byte for byte, the entry
  point's refusal.
* ``gpu`` tests (skipped without a card): both prefills on the card against
  the CPU within ``CARD_REL_TOL``, each with a control that must fail.

The reference's modules import JAX inside a ``try``: the card's machine
has no JAX, and there only the ``gpu`` tests run.
"""

import contextlib
import dataclasses
import json
import os
import zlib

import numpy as np
import pytest
import torch

try:                 # the card's machine has no JAX: only the ``gpu`` tests run there
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import manager as ref_manager
    from repro.configs import base as ref_base
    from repro.configs import get_config as ref_get_config
    from repro.core import zipnn as ref_zipnn
    from repro.data import pipeline as ref_pipeline
    from repro.models import attention as ref_attention
    from repro.models import build_model
    from repro.models import layers as ref_layers
    from repro.models.model import count_params_analytic as ref_count
    from repro.serve.step import greedy_generate as ref_greedy_generate
except ImportError:
    jax = None
from repro_torch import _util, convert
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import SHAPES, ModelConfig, get_config, list_archs, shape_cells
from repro_torch.configs import base
from repro_torch.core import zipnn
from repro_torch.data import DataConfig, batch_specs, make_batch, pipeline
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, decode_step, forward, init_decode_state, layers
from repro_torch.models.model import (
    count_params_analytic, init_params, param_dtypes, param_shapes, reference_norms,
)
from repro_torch.serve import (
    CompressedParamStore,
    KVCacheStore,
    greedy_generate,
    make_compressed_serve_step,
    make_kv_tiered_serve_step,
    make_prefill,
)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX for the reference")

REL_TOL = 1e-4
FLIP_TOL = 2e-3
POS_SHARE = 5e-2
ATTN_SHARE = 5e-3
ROW_SHARE = 5e-2
ROPE_SHARE = 1e-2
# One attention layer at qwen2_vl's published widths: the 1,536-wide bf16
# products round to the other neighbour on 2.7% of the output's entries
# with plain RoPE at these inputs and 5.0% with M-RoPE (10 of 16 rows),
# since every output entry sums 1,536 products in another order than
# XLA's; 10% keeps that and fails the control (plain RoPE against M-RoPE).
WIDE_SHARE = 1e-1
CARD_REL_TOL = 5e-3
B, S = 2, 100
HUFF = zipnn.ZipNNConfig(chunk_param_bytes=512, backend="huffman")
CKPT = dict(chunk_param_bytes=1 << 12, backend="huffman")
ALL_CONFIGS = sorted(list_archs() + ["repro_gpt_100m"])


def _port_config(jcfg):
    """A reference config as the port's ModelConfig, field for field."""
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _pair(name, **override):
    jcfg, cfg = ref_get_config(name).reduced(), get_config(name).reduced()
    return dataclasses.replace(jcfg, **override), dataclasses.replace(cfg, **override)


def _numpy_params(jcfg, seed=0):
    """``standard_normal * 0.02`` per leaf of the reference's tree, in each
    leaf's dtype: the numpy tree, the reference's arrays, the port's
    tensors (bit for bit)."""
    leaves, treedef = jax.tree_util.tree_flatten(build_model(jcfg).abstract_params())
    rng = np.random.default_rng(seed)
    nptree = jax.tree_util.tree_unflatten(treedef, [
        (rng.standard_normal(l.shape) * 0.02).astype(np.dtype(l.dtype)) for l in leaves])
    return (nptree, jax.tree_util.tree_map(jnp.asarray, nptree),
            convert.params_from_numpy(nptree, device="cpu"))


def _t(a):
    """A numpy array (bf16 included) as a CPU tensor, bit for bit."""
    return convert.params_from_numpy({"a": np.asarray(a)}, device="cpu")["a"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bf16_ulps(want, got: torch.Tensor) -> np.ndarray:
    """Per entry, how many bf16 steps apart (int16 bits of one sign)."""
    a = np.asarray(want).view(np.int16).astype(np.int32)
    return np.abs(a - got.view(torch.int16).numpy().astype(np.int32))


def _bf16_close(want, got: torch.Tensor, share: float) -> float:
    """Within one bf16 step of ``want``'s largest magnitude everywhere,
    different on at most ``share`` of entries; returns the share."""
    want = np.asarray(want).astype(np.float32)
    got = _np(got)
    assert got.shape == want.shape
    top = np.abs(want).max()
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    gap = np.abs(want - got)
    assert gap.max() <= step, (gap.max(), step)
    differ = float((gap > 0).mean())
    assert differ <= share, differ
    return differ


@contextlib.contextmanager
def pinned_hash():
    """``hash(cfg.name)`` in both pipelines' seeds pinned to the CRC-32 of
    the name (Python salts ``hash`` of a ``str`` per process)."""
    mods = [pipeline] + ([ref_pipeline] if jax is not None else [])
    for m in mods:
        m.hash = lambda name: zlib.crc32(name.encode())
    try:
        yield
    finally:
        for m in mods:
            del m.hash


def _thw(B, S, s_img, seed):
    """M-RoPE positions as the pipeline lays them out (a grid, then text),
    plus a seeded offset a row so the rows differ."""
    g = int(np.sqrt(s_img))
    hh, ww = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    grid = np.resize(np.stack([np.zeros_like(hh), hh, ww], -1).reshape(-1, 3), (s_img, 3))
    tpos = grid[:, 1].max() + 1 + np.arange(S - s_img)
    pos = np.concatenate([grid, np.stack([tpos] * 3, -1)], 0)
    off = np.random.default_rng(seed).integers(0, 50, (B, 1, 1))
    return (pos[None] + off).astype(np.int32)


# -- M-RoPE --------------------------------------------------------------------

MROPE_CASES = {
    "qwen2_vl-hd128": ((16, 24, 24), 128),
    "qwen2_vl-hd32-cut": ((16, 24, 24), 32),
    "short-last-runs-on": ((2, 3, 3), 32),
    "exact-hd32": ((4, 6, 6), 32),
}


@pytest.mark.parametrize("sections, n, want", [
    ((16, 24, 24), 64, [0] * 16 + [1] * 24 + [2] * 24),
    ((16, 24, 24), 16, [0] * 16),
    ((2, 3, 3), 16, [0, 0, 1, 1, 1] + [2] * 11),
    ((4, 0, 0), 8, [0] * 4 + [2] * 4),
], ids=["exact", "cut", "runs-on", "empty-sections"])
def test_mrope_section_ids_are_jnp_repeat(sections, n, want):
    assert layers.mrope_section_ids(sections, n) == want
    if jax is not None:
        ref = jnp.repeat(jnp.arange(3), jnp.asarray(sections), total_repeat_length=n)
        assert np.asarray(ref).tolist() == want


@needs_jax
@pytest.mark.parametrize("case", list(MROPE_CASES), ids=list(MROPE_CASES))
def test_apply_mrope_matches_reference(case):
    sections, hd = MROPE_CASES[case]
    rng = np.random.default_rng(hd + sum(sections))
    x = rng.standard_normal((2, 40, 3, hd)).astype(jnp.bfloat16.dtype)
    thw = _thw(2, 40, 16, seed=hd)
    want = jax.jit(lambda x, p: ref_layers.apply_mrope(x, p, 1e6, sections))(x, thw)
    got = layers.apply_mrope(_t(x), torch.from_numpy(thw), 1e6, sections)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    ulps = _bf16_ulps(want, got)
    worst = np.unravel_index(ulps.argmax(), ulps.shape)
    assert ulps.max() <= 1 and (ulps > 0).mean() <= ROPE_SHARE, (
        ulps.max(), (ulps > 0).mean(), worst, float(np.asarray(want, np.float32)[worst]),
        float(got.float()[worst]), thw[worst[:2]].tolist())


@pytest.mark.parametrize("sections, hd", list(MROPE_CASES.values()), ids=list(MROPE_CASES))
def test_apply_mrope_on_equal_positions_is_apply_rope(sections, hd):
    """t = h = w = p: every pair rotates by p, so M-RoPE is RoPE at p bit
    for bit."""
    x = torch.randn((2, 24, 3, hd), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    p = torch.arange(24, dtype=torch.int32)[None].expand(2, 24) * 37
    got = layers.apply_mrope(x, p[..., None].expand(2, 24, 3), 1e6, sections)
    assert torch.equal(got.view(torch.int16), layers.apply_rope(x, p, 1e6).view(torch.int16))


@needs_jax
def test_gqa_train_with_pos_thw_matches_reference_at_full_width():
    """qwen2_vl's one attention layer at its published widths (d_model
    1536, 12 heads of 128, 2 KV heads, QKV bias, M-RoPE (16, 24, 24), θ
    1e6) over S=16 rows of a grid and text: q, k, v and the output."""
    jcfg, cfg = ref_get_config("qwen2_vl_2b"), get_config("qwen2_vl_2b")
    rng = np.random.default_rng(4)
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    p = {}
    for k, (a, b) in shapes.items():
        p[k] = {"w": (rng.standard_normal((a, b)) * 0.02).astype(jnp.bfloat16.dtype)}
        if k != "wo":
            p[k]["b"] = (rng.standard_normal((b,)) * 0.02).astype(jnp.bfloat16.dtype)
    x = rng.standard_normal((1, 16, d)).astype(jnp.bfloat16.dtype)
    thw = _thw(1, 16, 9, seed=5)
    pos = np.arange(16, dtype=np.int32)[None]
    tp = convert.params_from_numpy(p, device="cpu")
    want = jax.jit(lambda p, x: ref_attention._qkv(p, x, jcfg, pos, thw))(p, x)
    got = attention._qkv(tp, _t(x), cfg, torch.from_numpy(pos), torch.from_numpy(thw))
    for w, g in zip(want, got):
        _bf16_close(w, g, ROPE_SHARE)
    want = jax.jit(lambda p, x: ref_attention.gqa_train(p, x, jcfg, pos, thw))(p, x)
    got = attention.gqa_train(tp, _t(x), cfg, torch.from_numpy(pos), torch.from_numpy(thw))
    assert got.shape == (1, 16, d)
    _bf16_close(want, got, WIDE_SHARE)
    # the control: plain RoPE from positions against the reference's M-RoPE
    plain = attention.gqa_train(tp, _t(x), cfg, torch.from_numpy(pos))
    with pytest.raises(AssertionError):
        _bf16_close(want, plain, WIDE_SHARE)


# -- the forward ---------------------------------------------------------------

FORWARD_CASES = {
    "qwen2_vl_2b": ("qwen2_vl_2b", {}),
    "qwen2_vl_2b-sections-4-6-6": ("qwen2_vl_2b", {"mrope_sections": (4, 6, 6)}),
    "hubert_xlarge": ("hubert_xlarge", {}),
}


STEPS = (0, 1, 2, 3)


class Case:
    """A config's params in both packages, the ``make_batch`` batches of
    ``STEPS`` drawn by each package under ``pinned_hash``, and the
    reference's jitted forward of each."""

    def __init__(self, name, override):
        self.jcfg, self.cfg = _pair(name, **override)
        self.model = build_model(self.jcfg)
        self.nptree, self.jparams, self.params = _numpy_params(self.jcfg)
        with pinned_hash():
            jbatches = [ref_pipeline.make_batch(self.jcfg, ref_pipeline.DataConfig(S, B), t)
                        for t in STEPS]
            self.batches = [make_batch(self.cfg, DataConfig(S, B), t, device="cpu")
                            for t in STEPS]
        jfwd = jax.jit(self.model.forward)
        outs = [jfwd(self.jparams, jb) for jb in jbatches]
        self.want = [np.asarray(logits) for logits, _ in outs]
        self.want_aux = [float(aux) for _, aux in outs]

    def row_gaps(self, logits) -> np.ndarray:
        """Every (batch, position) row's largest gap over its batch's
        largest logit, over all of ``STEPS``' batches."""
        out = []
        for got, want in zip(logits, self.want):
            assert got.shape == want.shape
            out.append(np.abs(want - got.numpy()).max(-1) / np.abs(want).max())
        return np.concatenate(out)


@pytest.fixture(scope="module", params=list(FORWARD_CASES), ids=list(FORWARD_CASES))
def case(request):
    if jax is None:
        pytest.skip("needs JAX for the reference")
    return Case(*FORWARD_CASES[request.param])


def test_forward_matches_reference(case):
    outs = [forward(case.cfg, case.params, b) for b in case.batches]
    for (logits, aux), want_aux in zip(outs, case.want_aux):
        assert logits.dtype == torch.float32 and logits.shape == (B, S, case.cfg.vocab_size)
        assert torch.isfinite(logits).all() and float(aux) == want_aux == 0.0
    gaps = case.row_gaps([logits for logits, _ in outs])
    assert gaps.max() <= FLIP_TOL, gaps.max()
    assert (gaps > REL_TOL).mean() <= POS_SHARE, (gaps > REL_TOL).mean()


def test_make_prefill_gives_the_forward_logits(case):
    logits, _ = forward(case.cfg, case.params, case.batches[0])
    assert torch.equal(make_prefill(case.cfg)(case.params, case.batches[0]), logits)


def test_hubert_attention_is_not_causal():
    """A change to the last frame moves the first row's logits, in both
    packages; a causal copy of the config leaves them."""
    if jax is None:
        pytest.skip("needs JAX for the reference")
    jcfg, cfg = _pair("hubert_xlarge")
    nptree, jparams, params = _numpy_params(jcfg, seed=1)
    frames = np.random.default_rng(2).standard_normal((1, 32, cfg.frontend_dim)) * 0.5
    moved = frames.copy()
    moved[:, -1] += 1.0
    jfwd = jax.jit(build_model(jcfg).forward)
    ref = [np.asarray(jfwd(jparams, {"frames": jnp.asarray(f, jnp.bfloat16)})[0])
           for f in (frames, moved)]
    port = [forward(cfg, params, {"frames": torch.from_numpy(f).to(torch.bfloat16)})[0]
            for f in (frames, moved)]
    assert np.abs(ref[0][:, 0] - ref[1][:, 0]).max() > 0
    assert (port[0][:, 0] - port[1][:, 0]).abs().max() > 0
    causal = dataclasses.replace(cfg, encoder_only=False)
    first = [forward(causal, params, {"frames": torch.from_numpy(f).to(torch.bfloat16)})[0]
             for f in (frames, moved)]
    assert torch.equal(first[0][:, :-1], first[1][:, :-1])


# -- param trees, counts, shape cells, batches ---------------------------------

def _ref_tree(jcfg):
    abstract = build_model(jcfg).abstract_params()
    return {"/".join(str(getattr(k, "key", k)) for k in path): (tuple(l.shape), str(l.dtype))
            for path, l in jax.tree_util.tree_flatten_with_path(abstract)[0]}


def _port_tree(cfg):
    dtypes = dict(_util.tree_flatten_with_keys(_util.tree_map(
        lambda d: _util.dtype_name(d), param_dtypes(cfg))))

    def walk(node, path, out):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,), out)
            else:
                out["/".join(path + (k,))] = (tuple(v), dtypes["/".join(path + (k,))])
        return out

    return walk(param_shapes(cfg), (), {})


@needs_jax
def test_reduced_hubert_params_draw_as_the_reference():
    """Repair: the port refused every encoder-only config's params.  Reduced
    hubert_xlarge's params draw, leaf for leaf the reference's shapes and
    dtypes (every leaf f32)."""
    jcfg = ref_get_config("hubert_xlarge").reduced()
    cfg = _port_config(jcfg)
    params = init_params(cfg, 0, device="cpu")
    want = _ref_tree(jcfg)
    got = {k: (tuple(v.shape), _util.dtype_name(v.dtype))
           for k, v in _util.tree_flatten_with_keys(params)}
    assert got == want
    assert {d for _, d in got.values()} == {"float32"}
    assert "frontend_proj/w" in got and "frontend_proj/b" not in got and "pos/table" in got


@needs_jax
@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_param_tree_and_counts_equal_the_reference(name):
    jcfg, cfg = ref_get_config(name), get_config(name)
    assert _port_tree(cfg) == _ref_tree(jcfg)
    assert count_params_analytic(cfg) == cfg.param_count() == ref_count(jcfg)
    assert cfg.active_param_count() == ref_count(jcfg, active_only=True)


def test_published_param_counts():
    assert get_config("qwen2_vl_2b").param_count() == 1_778_894_336
    assert get_config("hubert_xlarge").param_count() == 988_346_880
    olmoe = get_config("olmoe_1b_7b")
    assert olmoe.active_param_count() < olmoe.param_count()


@needs_jax
def test_shape_cells_equal_the_reference():
    assert list_archs() == ref_base.list_archs() and base.ARCHS == ref_base.ARCHS
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in ref_base.SHAPES.items()}
    for name in ALL_CONFIGS:
        got = [dataclasses.astuple(c) for c in shape_cells(get_config(name))]
        assert got == [dataclasses.astuple(c) for c in ref_base.shape_cells(ref_get_config(name))]


@needs_jax
@pytest.mark.parametrize("name", ["repro_gpt_100m", "qwen2_vl_2b", "hubert_xlarge"])
@pytest.mark.parametrize("step", [0, 5])
def test_make_batch_and_specs_equal_the_reference(name, step):
    """Compared in one process: the seed takes ``hash(cfg.name)``, which
    Python salts per process."""
    jcfg, cfg = _pair(name)
    for seq, batch in ((64, 2), (100, 3)):
        want = ref_pipeline.make_batch(jcfg, ref_pipeline.DataConfig(seq, batch, seed=3), step)
        got = make_batch(cfg, DataConfig(seq, batch, seed=3), step, device="cpu")
        specs = batch_specs(cfg, DataConfig(seq, batch))
        ref_specs = ref_pipeline.batch_specs(jcfg, ref_pipeline.DataConfig(seq, batch))
        assert sorted(got) == sorted(want) == sorted(specs) == sorted(ref_specs)
        for k, w in want.items():
            g = got[k]
            assert (tuple(g.shape), g.dtype) == specs[k]
            assert tuple(ref_specs[k].shape) == specs[k][0]
            assert _util.dtype_name(g.dtype) == str(w.dtype) == str(ref_specs[k].dtype)
            assert np.array_equal(_np(g), np.asarray(w).astype(_np(g).dtype)), k


# -- serving reduced qwen2_vl --------------------------------------------------

@needs_jax
def test_vlm_decode_step_matches_reference_from_its_state():
    """Five steps, each from the reference's state crossed bit for bit:
    logits and ``kv_v`` within 1e-4 of their largest, the rotated ``kv_k``
    one bf16 step on at most 1% of entries (the decode uses plain RoPE at
    ``pos``, as the reference's)."""
    jcfg, cfg = _pair("qwen2_vl_2b")
    model = build_model(jcfg)
    _, jparams, params = _numpy_params(jcfg, seed=2)
    jstep = jax.jit(model.decode_step)
    sa = model.init_decode_state(B, 5, start_pos=0)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (5, B, 1)).astype(np.int32)
    for t in toks:
        sb = convert.params_from_numpy({k: np.asarray(v) for k, v in sa.items()}, device="cpu")
        la, sa = jstep(jparams, sa, jnp.asarray(t))
        lb, sb = decode_step(cfg, params, sb, torch.from_numpy(t))
        la = np.asarray(la)
        assert np.abs(la - lb.numpy()).max() <= REL_TOL * np.abs(la).max()
        v = np.asarray(sa["kv_v"]).astype(np.float32)
        assert np.abs(v - _np(sb["kv_v"])).max() <= REL_TOL * np.abs(v).max()
        ulps = _bf16_ulps(sa["kv_k"], sb["kv_k"])
        assert ulps.max() <= 1 and (ulps > 0).mean() <= ROPE_SHARE


@needs_jax
def test_vlm_greedy_generate_gives_the_reference_tokens():
    jcfg, cfg = _pair("qwen2_vl_2b")
    _, jparams, params = _numpy_params(jcfg, seed=4)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    want, _ = ref_greedy_generate(build_model(jcfg), jparams, jnp.asarray(prompt), 16)
    got, _ = greedy_generate(cfg, params, torch.from_numpy(prompt), 16)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.fixture(scope="module")
def vlm():
    cfg = get_config("qwen2_vl_2b").reduced()
    params = init_params(cfg, 0, device="cpu")
    store = CompressedParamStore.from_params(params, HUFF, payload_feed=True, device="cpu")
    return cfg, params, store


def _plain_run(cfg, params, toks, length):
    state = init_decode_state(cfg, B, length, start_pos=0, device="cpu")
    out = []
    for t in toks:
        logits, state = decode_step(cfg, params, state, t)
        out.append(logits)
    return out, state


def test_vlm_store_keeps_frontend_proj_static(vlm):
    cfg, params, store = vlm
    assert store.stack_keys == ("layers",)
    assert sorted(store.static) == ["embed", "final_norm", "frontend_proj", "lm_head"]
    fp = params["frontend_proj"]["w"]
    assert torch.equal(store.static["frontend_proj"]["w"], fp)
    assert store.static_bytes == sum(t.numel() * t.element_size()
                                     for k in store.static for t in _util.tree_leaves(
                                         store.static[k]))
    assert store.footprint_bytes(2) > store.static_bytes >= fp.numel() * fp.element_size()


@pytest.mark.parametrize("tiles", [1, 2])
def test_vlm_ring_bit_identical_to_plain(vlm, tiles):
    cfg, params, store = vlm
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (6, B, 1)).astype(np.int32))
    want, want_state = _plain_run(cfg, params, toks, 6)
    step = make_compressed_serve_step(cfg, store, ring=2, tiles=tiles)
    state = init_decode_state(cfg, B, 6, start_pos=0, device="cpu")
    for t, w in zip(toks, want):
        logits, state = step(state, t)
        assert torch.equal(logits, w)
    for k in want_state:
        assert torch.equal(state[k], want_state[k]), k
    assert store.peak_resident <= 2 * tiles


@pytest.mark.parametrize("ring_kv", [False, True], ids=["plain-params", "ring"])
def test_vlm_kv_tier_bit_identical_to_plain(vlm, ring_kv):
    cfg, params, store = vlm
    n = 9
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (n, B, 1)).astype(np.int32))
    want, _ = _plain_run(cfg, params, toks, n)
    kv = KVCacheStore(init_decode_state(cfg, B, n, start_pos=0, device="cpu"),
                      hot_window=3, block_len=2, config=HUFF)
    if ring_kv:
        step = make_compressed_serve_step(cfg, store, ring=2, tiles=2, kv_store=kv)
        state = {"pos": torch.tensor(0, dtype=torch.int32)}
        for t, w in zip(toks, want):
            logits, state = step(state, t)
            assert torch.equal(logits, w)
    else:
        step = make_kv_tiered_serve_step(cfg, params, kv)
        for t, w in zip(toks, want):
            assert torch.equal(step(t), w)
    assert kv.n_cold_blocks > 0


def _files(directory, step):
    d = os.path.join(directory, f"step_{step}")
    return [open(os.path.join(d, n), "rb").read() for n in ("manifest.json", "data.bin")]


def _ref_save(directory, step, nptree):
    ref = ref_manager.CheckpointManager(ref_manager.CheckpointConfig(
        str(directory), zipnn=ref_zipnn.ZipNNConfig(**CKPT)))
    ref.save(step, {"params": nptree}, blocking=True)


@needs_jax
def test_serve_entry_point_restores_the_references_vlm_checkpoint(tmp_path, capsys):
    """``launch.serve --arch qwen2_vl_2b --reduced --ckpt-dir`` on a
    checkpoint the reference saved: the params bit for bit, the
    reference's greedy tokens on the same prompt (text only: the entry
    point decodes token prompts)."""
    jcfg, cfg = _pair("qwen2_vl_2b")
    nptree, jparams, _ = _numpy_params(jcfg, seed=8)
    _ref_save(tmp_path, 3, nptree)
    served = {}
    out = launch_serve.main(["--arch", "qwen2_vl_2b", "--reduced", "--ckpt-dir", str(tmp_path),
                             "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                             "--gen", "6"], params_out=served)
    text = capsys.readouterr().out
    assert "[serve] restored step 3 from ZipNN checkpoint" in text
    got, want = (_util.tree_flatten_with_keys(t) for t in (served, nptree))
    assert [k for k, _ in got] == [k for k, _ in want] and "frontend_proj/w" in dict(got)
    for (k, g), (_, w) in zip(got, want):
        assert np.array_equal(g.reshape(-1).view(torch.uint8).numpy(),
                              np.ascontiguousarray(w).reshape(-1).view(np.uint8)), k
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    ref, _ = ref_greedy_generate(build_model(jcfg), jparams, jnp.asarray(prompt), 6)
    assert out.shape == (2, 6) and np.array_equal(np.asarray(ref), out.numpy())


# -- reduced hubert: its f32 checkpoint, the entry point's refusal --------------

@needs_jax
def test_hubert_f32_checkpoint_equals_the_reference(tmp_path):
    """The port's save of reduced hubert's f32 params writes the
    reference's ``manifest.json`` and ``data.bin`` byte for byte (every
    entry f32, ``data.bin`` under the raw bytes), and its restore gives
    them back bit for bit."""
    jcfg, _ = _pair("hubert_xlarge")
    nptree, _, params = _numpy_params(jcfg, seed=9)
    _ref_save(tmp_path / "ref", 2, nptree)
    port = CheckpointManager(CheckpointConfig(str(tmp_path / "port"),
                                              zipnn=zipnn.ZipNNConfig(**CKPT), device="cpu"))
    port.save(2, {"params": params}, blocking=True)
    assert _files(str(tmp_path / "port"), 2) == _files(str(tmp_path / "ref"), 2)
    entries = json.loads(_files(str(tmp_path / "port"), 2)[0])["entries"]
    assert {e["dtype"] for e in entries} == {"float32"}
    assert "params/layers/mlp/w_in" in {e["key"] for e in entries}
    step, tree = port.restore(device_resident=True)
    assert step == 2
    for (k, g), (_, w) in zip(_util.tree_flatten_with_keys(tree["params"]),
                              _util.tree_flatten_with_keys(params)):
        assert g.dtype == w.dtype == torch.float32 and torch.equal(g.view(torch.int32),
                                                                   w.view(torch.int32)), k
    raw = sum(e["raw"] for e in entries)
    assert sum(len(b) for b in _files(str(tmp_path / "port"), 2)[1:]) < raw


def test_serve_entry_point_refuses_hubert(capsys):
    with pytest.raises(SystemExit, match="hubert_xlarge is encoder-only — nothing to decode"):
        launch_serve.main(["--arch", "hubert_xlarge", "--reduced", "--device", "cpu"])


def test_hubert_decode_entry_points_refuse():
    cfg = get_config("hubert_xlarge").reduced()
    with pytest.raises(ValueError, match="encoder-only: no decode state"):
        init_decode_state(cfg, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(cfg, {}, {"pos": torch.tensor(0)}, torch.zeros((2, 1), dtype=torch.int32))
    store = CompressedParamStore.from_params(init_params(cfg, 0, device="cpu"), HUFF,
                                             device="cpu")
    with pytest.raises(ValueError, match="no decode path"):
        make_compressed_serve_step(cfg, store)


# -- on the card (``gpu``) -----------------------------------------------------

def _card_case(name):
    """The reduced config, its control (qwen2_vl: plain RoPE from positions,
    ``mrope=False``; hubert: causal, ``encoder_only=False``), params with
    the reference's norms on the CPU, and a ``make_batch`` batch."""
    cfg = get_config(name).reduced()
    if name == "qwen2_vl_2b":
        cfg = dataclasses.replace(cfg, mrope_sections=(4, 6, 6))
        control = dataclasses.replace(cfg, mrope=False)
    else:
        control = dataclasses.replace(cfg, encoder_only=False)
    params = reference_norms(init_params(cfg, 0, device="cpu"))
    with pinned_hash():
        return cfg, control, params, make_batch(cfg, DataConfig(S, B), 2, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2_vl_2b", "hubert_xlarge"])
def test_prefill_on_card_matches_the_cpu(name):
    """``make_prefill`` on the card against the CPU, the same params and
    batch: the largest gap within ``CARD_REL_TOL`` of the largest logit;
    the control on the card goes over it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda", 0)
    cfg, control, params, batch = _card_case(name)
    card = _util.tree_map(lambda a: a.to(cuda), params)
    cbatch = {k: v.to(cuda) for k, v in batch.items()}
    want = make_prefill(cfg)(params, batch)
    got = make_prefill(cfg)(card, cbatch)
    assert got.device == cuda and torch.isfinite(got).all()
    top = want.abs().max()
    gap = (want - got.cpu()).abs().max()
    ctl_gap = (want - make_prefill(control)(card, cbatch).cpu()).abs().max()
    print(f"{name}: card against CPU {float(gap / top):.3e} of the largest logit, "
          f"control {float(ctl_gap / top):.3e}")
    assert gap <= CARD_REL_TOL * top
    assert ctl_gap > CARD_REL_TOL * top
