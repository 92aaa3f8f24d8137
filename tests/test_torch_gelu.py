"""The dense model's MLP activations and rounding points against the
reference's compiled decode step.

The reference's jitted ``decode_step`` (default XLA flags, on the CPU)
rounds to bf16 after every op of ``jax.nn.gelu`` and ``jax.nn.silu``, and
feeds the MLP norm the unrounded f32 sum ``x + attention`` (its optimised
HLO drops that one bf16 round).  The port follows those rounding points
(``repro_torch.models.layers.gelu_tanh_bf16``, ``silu_bf16``, ``gelu_mlp``
and ``blocks.dense_block_decode``).  Tolerances:

* the activations alone, on every finite bf16 value: bit-exact, except
  where XLA on the CPU flushes a subnormal input, intermediate or result
  to zero;
* the reduced ``repro_gpt_100m`` with one field changed, 5 teacher-forced
  steps at B=2: ``REL_TOL`` (1e-4 of the largest logit and cache entry),
  the limit of ``tests/test_torch_model.py`` and set there, and the same
  greedy tokens.  Before the repair ``mlp="gelu"`` read 3.11e-3 and
  ``qkv_bias=True`` 5.47e-4 (``ROADMAP.md`` §3); each repair undone alone
  reads above the limit again (``test_each_repair_undone_exceeds_the_limit``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.models import build_model
from repro.serve.step import greedy_generate as ref_greedy_generate
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention, blocks, decode_step, init_decode_state, layers
from repro_torch.serve import greedy_generate

REL_TOL = 1e-4


def _every_finite_bf16():
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    return x[torch.isfinite(x)]


def _reference(fn, x: torch.Tensor) -> torch.Tensor:
    u16 = jnp.asarray(x.view(torch.int16).numpy().view(np.uint16))
    out = jax.jit(lambda b: fn(jax.lax.bitcast_convert_type(b, jnp.bfloat16)))(u16)
    back = np.asarray(jax.lax.bitcast_convert_type(out, jnp.uint16)).view(np.int16)
    return torch.from_numpy(back.copy()).view(torch.bfloat16)


@pytest.mark.parametrize("name, port, ref", [
    ("gelu", layers.gelu_tanh_bf16, jax.nn.gelu),
    ("silu", layers.silu_bf16, jax.nn.silu),
])
def test_activation_matches_reference_on_every_bf16(name, port, ref):
    x = _every_finite_bf16()
    got, want = port(x), _reference(ref, x)
    same = got.view(torch.int16) == want.view(torch.int16)
    # XLA on the CPU flushes subnormal inputs, intermediates and results to
    # zero (x = -88.0 through SiLU: exp(88) makes 1 / (1 + .) subnormal):
    # the reference is then +-0 where the port keeps a value.  Nowhere else
    # may the two differ.
    flushed = want.float() == 0
    assert bool((same | flushed).all()), f"{name}: {int((~same & ~flushed).sum())} values differ"
    assert int((~flushed).sum()) > 40_000


@pytest.mark.parametrize("name, fused", [
    ("gelu", lambda x: F.gelu(x, approximate="tanh")),
    ("silu", F.silu),
])
def test_rounding_once_differs_from_reference(name, fused):
    """The control: the fused PyTorch activation, which rounds once, is
    not the reference's function (``1.0`` already differs for GELU)."""
    x = _every_finite_bf16()
    ref = jax.nn.gelu if name == "gelu" else jax.nn.silu
    differ = fused(x).view(torch.int16) != _reference(ref, x).view(torch.int16)
    assert int(differ.sum()) > 100


def _setup(**fields):
    jcfg = dataclasses.replace(ref_get_config("repro_gpt_100m").reduced(), **fields)
    model = build_model(jcfg)
    leaves, treedef = jax.tree_util.tree_flatten(model.abstract_params())
    rng = np.random.default_rng(0)
    np_leaves = [(rng.standard_normal(l.shape) * 0.02).astype(np.dtype(l.dtype)) for l in leaves]
    nptree = jax.tree_util.tree_unflatten(treedef, np_leaves)
    jparams = jax.tree_util.tree_map(jnp.asarray, nptree)
    cfg = dataclasses.replace(get_config("repro_gpt_100m").reduced(), **fields)
    return cfg, model, jparams, convert.params_from_numpy(nptree, device="cpu")


def _gaps(cfg, model, jparams, params, B=2, steps=5):
    """Largest logit gap over the largest logit across the steps, the
    same for each KV cache at the end, and whether every argmax agreed."""
    jstep = jax.jit(model.decode_step)
    sa = model.init_decode_state(B, steps, start_pos=0)
    sb = init_decode_state(cfg, B, steps, start_pos=0, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    gap, argmax_equal = 0.0, True
    for t in toks:
        la, sa = jstep(jparams, sa, jnp.asarray(t))
        lb, sb = decode_step(cfg, params, sb, torch.from_numpy(t))
        la, lb = np.asarray(la), lb.numpy()
        gap = max(gap, float(np.abs(la - lb).max() / np.abs(la).max()))
        argmax_equal &= bool(np.array_equal(la.argmax(-1), lb.argmax(-1)))
    kv = []
    for key in ("kv_k", "kv_v"):
        ka = np.asarray(sa[key]).astype(np.float32)
        kb = sb[key].to(torch.float32).numpy()
        kv.append(float(np.abs(ka - kb).max() / np.abs(ka).max()))
    return gap, kv, argmax_equal


# gelu: granite_20b's and hubert_xlarge's MLP; qkv_bias: qwen15_4b's; three
# SwiGLU layers: a depth at which F.silu's single rounding showed
@pytest.mark.parametrize("fields", [
    {"mlp": "gelu"},
    {"qkv_bias": True},
    {"n_layers": 3},
    {"mlp": "gelu", "qkv_bias": True, "norm": "layernorm"},
], ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()))
def test_model_matches_reference_teacher_forced(fields):
    cfg, model, jparams, params = _setup(**fields)
    gap, kv, argmax_equal = _gaps(cfg, model, jparams, params)
    assert gap <= REL_TOL and max(kv) <= REL_TOL and argmax_equal


def test_gelu_model_greedy_tokens_match_reference():
    cfg, model, jparams, params = _setup(mlp="gelu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    want, _ = ref_greedy_generate(model, jparams, jnp.asarray(prompt), 4)
    got, _ = greedy_generate(cfg, params, torch.from_numpy(prompt), 4)
    assert np.array_equal(np.asarray(want), got.numpy())


def _block_rounding_the_residual(p, x, caches, pos, cfg):
    """The block before the repair: the MLP norm reads x + a rounded to bf16."""
    h = blocks.norm_apply(cfg, p["attn_norm"], x)
    a, ck, cv = attention.gqa_decode(p["attn"], h, caches[0], caches[1], pos, cfg)
    x = x + a
    h = blocks.norm_apply(cfg, p["mlp_norm"], x)
    return x + blocks.mlp_apply(cfg, p["mlp"], h), (ck, cv)


@pytest.mark.parametrize("fields, module, name, fault", [
    ({"mlp": "gelu"}, layers, "gelu_tanh_bf16", lambda x: F.gelu(x, approximate="tanh")),
    ({"qkv_bias": True}, layers, "silu_bf16", F.silu),
    ({"n_layers": 3}, layers, "silu_bf16", F.silu),
    ({"mlp": "gelu"}, blocks, "dense_block_decode", _block_rounding_the_residual),
], ids=["gelu-rounded-once", "silu-rounded-once-qkv-bias", "silu-rounded-once-3-layers",
        "residual-rounded-before-the-norm"])
def test_each_repair_undone_exceeds_the_limit(monkeypatch, fields, module, name, fault):
    """The faults this file pins, each put back alone: the logits read above
    ``REL_TOL``.  (The QKV-bias reading of ``ROADMAP.md`` was SiLU's.)"""
    monkeypatch.setattr(module, name, fault)
    gap, _, _ = _gaps(*_setup(**fields))
    assert gap > REL_TOL
