"""The port's dense decode path against the reference model, and the
port's compressed ring against the port's own plain step.

Weights come from a numpy seed and cross with ``convert.params_from_numpy``
bit for bit.  Tolerances:

* port ``decode_step`` vs the reference's jitted ``decode_step`` on the
  CPU: both round activations to bf16 at the same places and accumulate
  in f32, so they differ only where f32 sums run in another order.  The
  limit, 1e-4 of the largest logit (and of the largest cache entry), is
  set between two readings on this test's inputs: the sound port reads
  2.3e-7, and bf16 controls — the same step with logits rounded to bf16
  (f32 accumulation off in the unembed) or with attention scores and
  softmax in bf16 — read 3.7e-3 and 1.3e-3.
  ``test_bf16_controls_exceed_the_limit`` keeps the controls above it;
* the ring vs the port's plain step: bit-identical (same ops on the same
  decoded bits), the contract the reference keeps for itself.

Ring tests use 512-byte chunks so the plain Huffman decode loop, which
runs one step per symbol of a chunk, stays short on the CPU.
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
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import device_entropy, zipnn
from repro_torch.models import attention, decode_step, init_decode_state, layers
from repro_torch.models.model import param_shapes
from repro_torch.serve import (
    CompressedParamStore,
    greedy_generate,
    make_compressed_serve_step,
    make_serve_step,
)

HUFF = zipnn.ZipNNConfig(chunk_param_bytes=512, backend="huffman")
REL_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = ref_get_config("repro_gpt_100m").reduced()
    model = build_model(jcfg)
    leaves, treedef = jax.tree_util.tree_flatten(model.abstract_params())
    rng = np.random.default_rng(0)
    np_leaves = [(rng.standard_normal(l.shape) * 0.02).astype(np.dtype(l.dtype)) for l in leaves]
    nptree = jax.tree_util.tree_unflatten(treedef, np_leaves)
    jparams = jax.tree_util.tree_map(jnp.asarray, nptree)
    cfg = get_config("repro_gpt_100m").reduced()
    params = convert.params_from_numpy(nptree, device="cpu")
    return cfg, model, jparams, params


def test_config_matches_reference():
    for reduced in (False, True):
        a, b = ref_get_config("repro_gpt_100m"), get_config("repro_gpt_100m")
        if reduced:
            a, b = a.reduced(), b.reduced()
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                  "vocab_size", "norm", "mlp", "pos_embedding", "rope_theta", "norm_eps"):
            assert getattr(a, f) == getattr(b, f), f
        assert b.dtype == torch.bfloat16


@pytest.mark.parametrize("reduced", [True, False])
def test_param_shapes_match_reference_tree(reduced):
    jcfg = ref_get_config("repro_gpt_100m")
    cfg = get_config("repro_gpt_100m")
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    abstract = build_model(jcfg).abstract_params()          # eval_shape: no allocation
    want = [tuple(l.shape) for l in jax.tree_util.tree_leaves(abstract)]

    def shapes(node):                 # shape tuples are leaves here, not nodes
        if isinstance(node, dict):
            return [s for k in sorted(node) for s in shapes(node[k])]
        return [node]

    got = param_shapes(cfg)
    assert shapes(got) == want
    if not reduced:                   # 226.5 MB of stacked bf16 weights
        assert sum(2 * int(np.prod(s)) for s in shapes(got["layers"])) == 226_529_280


def _teacher_forced_gaps(setup, B=2, steps=5):
    """Port vs reference ``decode_step`` on the same tokens: the largest
    logit gap over the largest logit, across steps, and the same for each
    KV cache at the end, and whether every step's argmax agreed.  Shapes,
    dtypes and ``pos`` are asserted on the way."""
    cfg, model, jparams, params = setup
    jstep = jax.jit(model.decode_step)
    sa = model.init_decode_state(B, steps, start_pos=0)
    sb = init_decode_state(cfg, B, steps, start_pos=0, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    logit_gap, argmax_equal = 0.0, True
    for t in toks:
        la, sa = jstep(jparams, sa, jnp.asarray(t))
        lb, sb = decode_step(cfg, params, sb, torch.from_numpy(t))
        la, lb = np.asarray(la), lb.numpy()
        assert lb.dtype == np.float32 and lb.shape == la.shape == (B, 1, cfg.vocab_size)
        logit_gap = max(logit_gap, float(np.abs(la - lb).max() / np.abs(la).max()))
        argmax_equal &= bool(np.array_equal(la.argmax(-1), lb.argmax(-1)))
    assert int(sb["pos"]) == int(sa["pos"]) == steps
    kv_gaps = []
    for key in ("kv_k", "kv_v"):
        ka = np.asarray(sa[key]).astype(np.float32)
        kb = sb[key].to(torch.float32).numpy()
        kv_gaps.append(float(np.abs(ka - kb).max() / np.abs(ka).max()))
    return logit_gap, kv_gaps, argmax_equal


def test_decode_step_matches_reference_teacher_forced(setup):
    logit_gap, kv_gaps, argmax_equal = _teacher_forced_gaps(setup)
    assert logit_gap <= REL_TOL
    assert max(kv_gaps) <= REL_TOL
    assert argmax_equal


def _unembed_bf16(p, x):
    return (x.to(torch.bfloat16) @ p["table"].to(torch.bfloat16).T).to(torch.float32)


@pytest.mark.parametrize("control", ["logits_bf16", "attention_bf16"])
def test_bf16_controls_exceed_the_limit(setup, monkeypatch, control):
    """A precision fault of the size the limit must catch: the same step
    with the unembed's f32 accumulation off, or with attention scores and
    softmax in bf16, reads well above ``REL_TOL``."""
    if control == "logits_bf16":
        monkeypatch.setattr(layers, "unembed", _unembed_bf16)
    else:
        monkeypatch.setattr(attention, "_f32", lambda t: t.to(torch.bfloat16))
    logit_gap, _, _ = _teacher_forced_gaps(setup)
    assert logit_gap > 10 * REL_TOL


def test_greedy_generate_tokens_match_reference(setup):
    cfg, model, jparams, params = setup
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    want, _ = ref_greedy_generate(model, jparams, jnp.asarray(prompt), 4)
    got, state = greedy_generate(cfg, params, torch.from_numpy(prompt), 4)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert int(state["pos"]) == 7


def _lockstep(cfg, params, cstep, steps=3, seed=0):
    """Plain step and the ring on the same tokens: logits and every state
    leaf must match bit for bit at every step."""
    B = 2
    plain = make_serve_step(cfg)
    sa = init_decode_state(cfg, B, steps, start_pos=0, device="cpu")
    sb = init_decode_state(cfg, B, steps, start_pos=0, device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))
        la, sa = plain(params, sa, toks)
        lb, sb = cstep(sb, toks)
        if not torch.equal(la.view(torch.int32), lb.view(torch.int32)):
            return False
        if any(not torch.equal(sa[k], sb[k]) for k in sa):
            return False
    return True


@pytest.mark.parametrize("ring", [1, 2, 3])
def test_ring_bit_identical_to_plain_step(setup, ring):
    cfg, _, _, params = setup
    store = CompressedParamStore.from_params(params, HUFF, payload_feed=True, device="cpu")
    device_entropy.reset_transfer_stats()
    cstep = make_compressed_serve_step(cfg, store, ring=ring)
    assert _lockstep(cfg, params, cstep)
    assert store.peak_resident <= ring
    assert device_entropy.transfer_stats()["payload_uploads"] == 0


def test_ring_without_feed_or_prefetch(setup):
    cfg, _, _, params = setup
    store = CompressedParamStore.from_params(params, HUFF, device="cpu")
    assert store.device_payload_bytes == 0
    assert _lockstep(cfg, params, make_compressed_serve_step(cfg, store, prefetch=False), steps=2)
    assert store.peak_resident == 1


def test_ring_greedy_generate_matches_plain(setup):
    cfg, _, _, params = setup
    store = CompressedParamStore.from_params(params, HUFF, payload_feed=True, device="cpu")
    prompt = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
    )
    la, lb = [], []
    ta, _ = greedy_generate(cfg, params, prompt, 2, logits_out=la)
    tb, _ = greedy_generate(cfg, None, prompt, 2, serve_step=make_compressed_serve_step(cfg, store),
                            logits_out=lb)
    assert torch.equal(ta, tb) and len(la) == len(lb) == 4
    assert all(torch.equal(a, b) for a, b in zip(la, lb))


def test_ring_and_generate_validation(setup):
    cfg, _, _, params = setup
    store = CompressedParamStore.from_params(params, HUFF, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        make_compressed_serve_step(cfg, store, ring=0)
    bigger = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
    with pytest.raises(ValueError, match="layers"):
        make_compressed_serve_step(bigger, store)
    with pytest.raises(ValueError, match="at least one token"):
        greedy_generate(cfg, params, torch.zeros((2, 0), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="steps"):
        greedy_generate(cfg, params, torch.zeros((2, 1), dtype=torch.int32), -1)
    out, _ = greedy_generate(cfg, params, torch.zeros((2, 1), dtype=torch.int32), 0)
    assert out.shape == (2, 0) and out.dtype == torch.int32
