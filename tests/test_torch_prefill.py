"""The whole forward pass and ``make_prefill`` in the port, per family,
against the reference's jitted ``forward`` and against the port's own
decode loop, at ``reduced()`` size.

Configs: ``repro_gpt_100m`` (dense, RoPE), ``h2o_danube3_4b`` (a 64-token
window at reduced size, crossed by S = 100), ``granite_20b`` (MQA, learned
positions, layernorm, GELU, QKV bias), ``olmoe_1b_7b`` (MoE at the
capacity factor 1.25: tokens drop), ``deepseek_v2_236b`` (a dense layer,
then MLA and routed plus shared experts), ``mamba2_130m`` (SSM) and
``zamba2_7b`` (hybrid; with ``n_layers=5`` for the ``mamba_tail``).  B=2,
S=100, so the flash loop pads both block sizes (64) and the SSD scan pads
its chunk (32).  Weights come from a numpy seed (``standard_normal *
0.02`` a leaf) and cross to the port bit for bit.

Limits against the reference:

* ``aux`` within 1e-6;
* logits within ``REL_TOL`` (1e-4) of the largest logit at all but
  ``POS_SHARE`` (5%) of the (batch, position) rows, and within
  ``FLIP_TOL`` (2e-3) at every row.  The port rounds where the reference
  does, but the two packages' f32 ``exp``, dots and sums differ in the last
  bit, so a bf16 activation next to a rounding boundary now and then
  rounds to its other neighbour (0.01-0.02% of a block's attention
  output, ``tests/test_torch_forward.py``), and the flip moves the rows
  downstream of it.  Readings on these inputs (largest gap, share of rows
  above ``REL_TOL``): repro_gpt 4.5e-5, 0; h2o 2.4e-7, 0; granite 8.4e-4,
  1%; olmoe 2.1e-7, 0; deepseek 7.7e-4, 0.5%; mamba2 2.3e-7, 0 (held
  to ``REL_TOL`` at every row, ``tests/test_torch_ssm.py``'s limit: it has
  no attention); zamba2 2.9e-4, 0.5%.  The bf16 control, a dense softmax
  in place of the flash loop (it rounds the normalised weights, not ``p``,
  to bf16), puts 12-97% of the rows above ``REL_TOL`` and reads 9e-4 to
  3.4e-3 at its largest: ``test_dense_softmax_control_exceeds_the_limit``.

Against the port's own decode loop (``greedy_generate``'s prompt logits),
on ``init_params`` with the reference's norms (``reference_norms``: gains
1; with ``init_params``' 0.02 gains the blocks move the logits by under
1e-3 of the largest, and a lost block passes any limit set on them): the
reference's limit for itself (``tests/test_models.py``), ``atol = rtol =
8e-2``, and for MLA equal argmax with a mean gap under 5e-2; MoE at a
capacity factor of 8.0, where no token drops, as the reference holds it.
The reference's rule alone passes a lost block at logits of about 1, so
the largest gap is also held under ``DECODE_REL_TOL`` (3e-2) of the
largest logit, and the control, one block's output zeroed (``_control``),
must go over it.  Readings on this test's inputs (largest gap over the
largest logit): 2.6e-3 (mamba2) to 7.9e-3 (deepseek); the control 8.6e-2
(olmoe) to 1.01.

The reference's modules import JAX inside a ``try``: the card's machine
has no JAX, and there only the ``gpu`` test runs.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

try:                 # the card's machine has no JAX: only the ``gpu`` test runs there
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model
except ImportError:
    jax = None
from repro_torch import _util, convert
from repro_torch.configs import get_config
from repro_torch.models import attention, forward
from repro_torch.models.model import init_params, reference_norms
from repro_torch.serve import greedy_generate, make_prefill

REL_TOL = 1e-4
DECODE_REL_TOL = 3e-2
FLIP_TOL = 2e-3
POS_SHARE = 5e-2
AUX_TOL = 1e-6
B, S = 2, 100
# (name, n_layers override)
CASES = [("repro_gpt_100m", None), ("h2o_danube3_4b", None), ("granite_20b", None),
         ("olmoe_1b_7b", None), ("deepseek_v2_236b", None), ("mamba2_130m", None),
         ("zamba2_7b", None), ("zamba2_7b", 5)]
CASE_IDS = ["repro_gpt_100m", "h2o_danube3_4b", "granite_20b", "olmoe_1b_7b",
            "deepseek_v2_236b", "mamba2_130m", "zamba2_7b", "zamba2_7b-tail"]


def _configs(name, n_layers=None, **override):
    jcfg, cfg = ref_get_config(name).reduced(), get_config(name).reduced()
    if n_layers:
        override["n_layers"] = n_layers
    return dataclasses.replace(jcfg, **override), dataclasses.replace(cfg, **override)


class Case:
    """One config's params in both packages, a prompt, and the
    reference's jitted forward of it."""

    def __init__(self, name, n_layers):
        self.name = name
        self.jcfg, self.cfg = _configs(name, n_layers)
        self.model = build_model(self.jcfg)
        leaves, treedef = jax.tree_util.tree_flatten(self.model.abstract_params())
        rng = np.random.default_rng(0)
        np_leaves = [(rng.standard_normal(l.shape) * 0.02).astype(np.dtype(l.dtype))
                     for l in leaves]
        self.nptree = jax.tree_util.tree_unflatten(treedef, np_leaves)
        self.jparams = jax.tree_util.tree_map(jnp.asarray, self.nptree)
        self.params = convert.params_from_numpy(self.nptree, device="cpu")
        self.tokens = np.random.default_rng(1).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)
        logits, aux = jax.jit(self.model.forward)(self.jparams,
                                                 {"tokens": jnp.asarray(self.tokens)})
        self.want, self.want_aux = np.asarray(logits), float(aux)

    def batch(self):
        return {"tokens": torch.from_numpy(self.tokens)}

    def row_gaps(self, logits: torch.Tensor) -> np.ndarray:
        """Each (batch, position) row's largest gap over the largest logit."""
        got = logits.numpy()
        assert got.shape == self.want.shape
        return np.abs(self.want - got).max(-1) / np.abs(self.want).max()


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def case(request):
    if jax is None:
        pytest.skip("needs JAX for the reference")
    return Case(*request.param)


def test_forward_matches_reference(case):
    logits, aux = forward(case.cfg, case.params, case.batch())
    assert logits.dtype == torch.float32 and logits.shape == (B, S, case.cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - case.want_aux) <= AUX_TOL
    assert (float(aux) > 0) == case.cfg.moe
    gaps = case.row_gaps(logits)
    if case.cfg.family == "ssm":
        assert gaps.max() <= REL_TOL, gaps.max()
    assert gaps.max() <= FLIP_TOL, gaps.max()
    assert (gaps > REL_TOL).mean() <= POS_SHARE, (gaps > REL_TOL).mean()


def test_make_prefill_gives_the_forward_logits(case):
    logits, _ = forward(case.cfg, case.params, case.batch())
    assert torch.equal(make_prefill(case.cfg)(case.params, case.batch()), logits)


@pytest.mark.parametrize("name", ["repro_gpt_100m", "granite_20b", "deepseek_v2_236b",
                                  "zamba2_7b"])
def test_dense_softmax_control_exceeds_the_limit(monkeypatch, name):
    """A dense softmax in place of the flash loop puts more than
    ``POS_SHARE`` of the rows above ``REL_TOL``: the limit bites."""
    c = Case(name, None)

    def dense(q, k, v, *, causal, window=0, q_block=0, kv_block=0):
        return attention.dense_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(attention, "flash_attention", dense)
    logits, _ = forward(c.cfg, c.params, c.batch())
    assert (c.row_gaps(logits) > REL_TOL).mean() > POS_SHARE


def test_moe_prefill_drops_tokens(monkeypatch):
    """At B=2, S=100 and the capacity factor 1.25 the reduced olmoe's
    prefill (the params and prompt of ``test_forward_matches_reference``)
    drops token-expert pairs in its dispatch, and its logits still agree
    with the reference's: it drops the same ones."""
    from repro_torch.models import moe

    if jax is None:
        pytest.skip("needs JAX for the reference")
    c = Case("olmoe_1b_7b", None)
    assert c.cfg.capacity_factor == 1.25
    dropped = []
    dispatch = moe.dispatch

    def counted(xt, idx, C, E):
        buf, sort, pos = dispatch(xt, idx, C, E)
        dropped.append(int((pos < 0).sum()))
        return buf, sort, pos

    monkeypatch.setattr(moe, "dispatch", counted)
    logits = make_prefill(c.cfg)(c.params, c.batch())
    assert len(dropped) == c.cfg.n_layers and sum(dropped) > 0, dropped
    gaps = c.row_gaps(logits)
    assert gaps.max() <= FLIP_TOL and (gaps > REL_TOL).mean() <= POS_SHARE


# the control: the first layer's (hybrid: group 0's first layer's) mixer
# output projection zeroed, so that one block's output is lost
CONTROL_LEAF = {"dense": (("layers", "attn", "wo", "w"), (0,)),
                "moe": (("moe_layers", "moe", "experts", "w_down"), (0,)),
                "ssm": (("layers", "mamba", "out_proj", "w"), (0,)),
                "hybrid": (("mamba_groups", "mamba", "out_proj", "w"), (0, 0))}


def _control(cfg, params):
    path, at = CONTROL_LEAF[cfg.family]

    def walk(node, i):
        if i == len(path):
            t = node.clone()
            t[at] = 0
            return t
        return {**node, path[i]: walk(node[path[i]], i + 1)}

    return walk(params, 0)


def _gap_rel(got, want):
    """The largest gap over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name, n_layers", CASES, ids=CASE_IDS)
def test_forward_matches_own_decode_loop(name, n_layers):
    """The port's forward against the port's decode loop over the same
    prompt: the reference's own decode-vs-forward limit, and
    ``DECODE_REL_TOL``, which the control fails."""
    _, cfg = _configs(name, n_layers)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)   # no drops
    params = reference_norms(init_params(cfg, 1, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 24)).astype(np.int32))
    prefill = make_prefill(cfg)
    fwd = prefill(params, {"tokens": toks})
    steps: list = []
    greedy_generate(cfg, params, toks, 0, logits_out=steps)
    dec = torch.cat(steps, dim=1)
    assert dec.shape == fwd.shape
    if cfg.mla:
        assert torch.equal(dec.argmax(-1), fwd.argmax(-1))
        assert (dec - fwd).abs().mean() < 5e-2
    else:
        np.testing.assert_allclose(dec.numpy(), fwd.numpy(), atol=8e-2, rtol=8e-2)
    assert _gap_rel(fwd, dec) <= DECODE_REL_TOL
    assert _gap_rel(prefill(_control(cfg, params), {"tokens": toks}), dec) > DECODE_REL_TOL


@pytest.mark.parametrize("name", ["granite_20b", "deepseek_v2_236b", "zamba2_7b"])
def test_reference_norms_sets_the_norms_and_shares_the_rest(name):
    """Every norm's gain 1 and layernorm bias 0 (granite's layernorms,
    deepseek's ``q_norm`` / ``kv_norm``, zamba2's gated norms); every other
    leaf the same tensor."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, 0, device="cpu")
    got = _util.tree_flatten_with_keys(reference_norms(params))
    want = _util.tree_flatten_with_keys(params)
    assert [k for k, _ in got] == [k for k, _ in want]
    n_norms = 0
    for (key, a), (_, b) in zip(got, want):
        path = key.split("/")
        if any(p.endswith("norm") for p in path[:-1]):
            n_norms += 1
            assert torch.equal(a, torch.full_like(b, 1.0 if path[-1] == "g" else 0.0))
        else:
            assert a is b
    assert n_norms >= 3


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_vlm_and_audio_raise(family):
    """The vlm and audio prefills, reduced ``qwen2_vl_2b`` (patches, then
    text, under M-RoPE) and ``hubert_xlarge`` (frames, non-causal, f32
    params), against the jitted reference ``forward`` on the same params and
    the same ``data.make_batch`` batches of steps 0-3 (drawn by each
    package with ``hash(cfg.name)`` pinned: Python salts it per process),
    at this file's limits over the four batches' rows."""
    if jax is None:
        pytest.skip("needs JAX for the reference")
    from repro.data import pipeline as ref_pipeline
    from repro_torch.data import DataConfig, make_batch, pipeline

    name = {"vlm": "qwen2_vl_2b", "audio": "hubert_xlarge"}[family]
    jcfg, cfg = _configs(name)
    assert cfg.family == family
    model = build_model(jcfg)
    leaves, treedef = jax.tree_util.tree_flatten(model.abstract_params())
    rng = np.random.default_rng(0)
    nptree = jax.tree_util.tree_unflatten(treedef, [
        (rng.standard_normal(l.shape) * 0.02).astype(np.dtype(l.dtype)) for l in leaves])
    params = convert.params_from_numpy(nptree, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, nptree)
    jfwd, prefill = jax.jit(model.forward), make_prefill(cfg)
    gaps = []
    for step in range(4):
        for m in (pipeline, ref_pipeline):
            m.hash = lambda s: zlib.crc32(s.encode())
        try:
            jbatch = ref_pipeline.make_batch(jcfg, ref_pipeline.DataConfig(S, B), step)
            batch = make_batch(cfg, DataConfig(S, B), step, device="cpu")
        finally:
            for m in (pipeline, ref_pipeline):
                del m.hash
        want = np.asarray(jfwd(jparams, jbatch)[0])
        got = prefill(params, batch)
        assert got.dtype == torch.float32 and got.shape == want.shape == (B, S, cfg.vocab_size)
        gaps.append(np.abs(want - got.numpy()).max(-1) / np.abs(want).max())
    gaps = np.concatenate(gaps)
    assert gaps.max() <= FLIP_TOL, gaps.max()
    assert (gaps > REL_TOL).mean() <= POS_SHARE, (gaps > REL_TOL).mean()


def test_forward_raises_on_a_device_mix():
    cfg = get_config("repro_gpt_100m").reduced()
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="more than one device"):
        forward(cfg, params, {"tokens": torch.zeros((1, 4), dtype=torch.int32,
                                                    device="meta")})
    params["final_norm"]["g"] = params["final_norm"]["g"].to("meta")
    with pytest.raises(ValueError, match="more than one device"):
        forward(cfg, params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


# -- on the card (``gpu``) -----------------------------------------------------

# Card against CPU, as ``tests/test_torch_ssm.py`` holds the decode step:
# the two devices' f32 sums run in other orders, so a bf16 activation
# rounds to its other neighbour now and then, and the flip moves the logits
# downstream of it.  Held on the reference's norms, where the control, one
# block's output zeroed on the card side, must go over it.  Readings on an
# H100 (largest gap over the largest logit): 1.8e-3 (olmoe) to 4.9e-3
# (zamba2 with its tail), mamba2 0; the control 0.14 (olmoe) to 1.02.
CARD_REL_TOL = 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("name, n_layers", CASES, ids=CASE_IDS)
def test_prefill_on_card_matches_the_cpu(name, n_layers):
    """``make_prefill`` on the card against the CPU on the same params
    (``init_params`` with the reference's norms) and prompt: logits within
    ``CARD_REL_TOL`` of the largest, aux within 1e-5; the control on the
    card goes over ``CARD_REL_TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda", 0)
    cfg = get_config(name).reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = reference_norms(init_params(cfg, 0, device="cpu"))
    card = _util.tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    la, aux_a = forward(cfg, params, {"tokens": toks})
    lb, aux_b = forward(cfg, card, {"tokens": toks.to(cuda)})
    assert lb.device == cuda and torch.isfinite(lb).all()
    top = la.abs().max()
    gap = (la - lb.cpu()).abs().max()
    ctl, _ = forward(cfg, _control(cfg, card), {"tokens": toks.to(cuda)})
    ctl_gap = (la - ctl.cpu()).abs().max()
    print(f"{name}: card against CPU {float(gap / top):.3e} of the largest logit, "
          f"control {float(ctl_gap / top):.3e}")
    assert gap <= CARD_REL_TOL * top
    assert ctl_gap > CARD_REL_TOL * top
    assert abs(float(aux_a) - float(aux_b)) <= 1e-5
