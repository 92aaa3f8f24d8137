"""The serving paths of the MoE family at ``reduced()`` size: the store's
stack keys against the reference's, the compressed ring and the MLA KV
tier against the port's own plain step, the serving entry point, the vlm
family's entry points and the rejections the port keeps from the
reference.

* Store: ``CompressedParamStore.from_params`` on the same seeded params
  in both packages gives the same stack keys, the same static keys,
  byte-identical per-layer blobs and the same byte counts.
* Ring (whole layers and tiles) and KV tier: logits bit-identical to
  :func:`repro_torch.models.decode_step`; evicted MLA blocks
  byte-identical to the reference's ``KVCacheStore`` fed the same
  entries.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import zipnn as ref_zipnn
from repro.core.options import CodecOptions as RefOptions
from repro.models import build_model
from repro.serve import KVCacheStore as RefKVStore
from repro.serve.compressed import CompressedParamStore as RefStore
from repro_torch import convert
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import zipnn
from repro_torch.launch import serve as launch_serve
from repro_torch.models import decode_step, init_decode_state
from repro_torch.models.model import cache_keys, init_params, param_shapes
from repro_torch.serve import (
    CompressedParamStore,
    KVCacheStore,
    greedy_generate,
    make_compressed_serve_step,
    make_kv_tiered_serve_step,
    make_serve_step,
)
from repro_torch.serve.compressed import DEFAULT_STACK_KEYS

ARCHS = ["olmoe_1b_7b", "deepseek_v2_236b"]
HUFF = zipnn.ZipNNConfig(chunk_param_bytes=512, backend="huffman")
REF_HUFF = ref_zipnn.ZipNNConfig(chunk_param_bytes=512, backend="huffman")
HOT, BLK = 3, 2


def _numpy_params(name, seed=0):
    """``standard_normal * 0.02`` per leaf of the reference's tree (the
    router in f32): the reference's arrays and the port's tensors."""
    jcfg = ref_get_config(name).reduced()
    leaves, treedef = jax.tree_util.tree_flatten(build_model(jcfg).abstract_params())
    rng = np.random.default_rng(seed)
    nptree = jax.tree_util.tree_unflatten(treedef, [
        (rng.standard_normal(l.shape) * 0.02).astype(np.dtype(l.dtype)) for l in leaves])
    return jax.tree_util.tree_map(jnp.asarray, nptree), convert.params_from_numpy(nptree, device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_config(request.param).reduced()
    params = init_params(cfg, 0, device="cpu")
    return cfg, params, CompressedParamStore.from_params(params, HUFF, payload_feed=True,
                                                         device="cpu")


def test_default_stack_keys_are_the_reference():
    from repro.serve.compressed import DEFAULT_STACK_KEYS as ref_keys

    assert DEFAULT_STACK_KEYS == ref_keys == ("layers", "dense_layers", "moe_layers")


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("config, ref_config", [
    (HUFF, REF_HUFF),
    (zipnn.DEFAULT, ref_zipnn.DEFAULT),
], ids=["huffman", "default"])
def test_store_from_params_equals_the_reference(name, config, ref_config):
    """Every stack compressed per layer as the reference's store does: no
    MoE stack is left raw in ``static``."""
    jparams, params = _numpy_params(name)
    ref = RefStore.from_params(jparams, ref_config, options=RefOptions(backend="host"))
    port = CompressedParamStore.from_params(params, config, device="cpu")
    want_keys = ("moe_layers",) if name == "olmoe_1b_7b" else ("dense_layers", "moe_layers")
    assert port.stack_keys == ref.stack_keys == want_keys
    assert sorted(port.static) == sorted(ref.static)
    assert not set(port.static) & set(DEFAULT_STACK_KEYS)
    for key in port.stack_keys:
        assert port.n_layers(key) == ref.n_layers(key) > 0
        for i in range(port.n_layers(key)):
            got = [ct.blob for ct in port.manifest(key, i)["leaves"]]
            want = [ct.blob for ct in ref._stacks[key][i]["leaves"]]
            assert got == want, (key, i)
    assert port.comp_bytes == ref.comp_bytes < port.raw_bytes == ref.raw_bytes
    assert port.static_bytes == ref.static_bytes
    if name == "olmoe_1b_7b" and config is zipnn.DEFAULT:
        # the reading ROADMAP.md §3 records (the parent's store held 0 of them)
        assert (port.comp_bytes, port.raw_bytes) == (660_087, 992_256)


def _plain(cfg, params, toks, length):
    state = init_decode_state(cfg, toks.shape[1], length, start_pos=0, device="cpu")
    out = []
    for t in toks:
        logits, state = decode_step(cfg, params, state, t)
        out.append(logits)
    return out, state


def _toks(cfg, steps, B=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (steps, B, 1)).astype(np.int32))


@pytest.mark.parametrize("tiles", [1, 2])
def test_ring_bit_identical_to_plain(model, tiles):
    cfg, params, store = model
    toks = _toks(cfg, 6)
    want, state = _plain(cfg, params, toks, 6)
    cstep = make_compressed_serve_step(cfg, store, ring=2, tiles=tiles)
    store.reset_peak()
    got = init_decode_state(cfg, 2, 6, start_pos=0, device="cpu")
    for s, t in enumerate(toks):
        logits, got = cstep(got, t)
        assert torch.equal(logits.view(torch.int32), want[s].view(torch.int32)), s
    for k in cache_keys(cfg):
        assert torch.equal(got[k], state[k])
    assert 0 < store.peak_resident <= 2 * tiles


def test_ring_through_greedy_generate(model):
    cfg, params, store = model
    prompt = _toks(cfg, 4, seed=1)[:, :, 0].T.contiguous()
    la, lb = [], []
    ta, _ = greedy_generate(cfg, params, prompt, 5, logits_out=la)
    tb, _ = greedy_generate(cfg, None, prompt, 5, logits_out=lb,
                            serve_step=make_compressed_serve_step(cfg, store, tiles=3))
    assert torch.equal(ta, tb) and all(torch.equal(a, b) for a, b in zip(la, lb))
    tc, _ = greedy_generate(cfg, params, prompt, 5, serve_step=lambda s, t: make_serve_step(
        cfg)(params, s, t))
    assert torch.equal(ta, tc)


def test_ring_rejects_a_store_without_the_moe_stack(model):
    cfg, params, _ = model
    cut = {k: v for k, v in params.items() if k != "moe_layers"}
    store = CompressedParamStore.from_params(cut, HUFF, device="cpu")
    with pytest.raises(ValueError, match="moe_layers"):
        make_compressed_serve_step(cfg, store)


@pytest.mark.parametrize("tiles", [1, 2])
def test_kv_tiered_ring_bit_identical_to_plain(model, tiles):
    """The KV tier under the ring (and under plain params): logits
    bit-identical to the untiered step with blocks evicted, the tier
    invisible in the caches put back together."""
    cfg, params, store = model
    steps = 10
    toks = _toks(cfg, steps, seed=2)
    want, state = _plain(cfg, params, toks, steps)
    kv = KVCacheStore(init_decode_state(cfg, 2, steps, start_pos=0, device="cpu"),
                      hot_window=HOT, block_len=BLK, config=HUFF)
    assert kv.keys == cache_keys(cfg)
    cstep = make_compressed_serve_step(cfg, store, ring=2, tiles=tiles, kv_store=kv)
    st = {"pos": torch.tensor(0, dtype=torch.int32)}
    for s, t in enumerate(toks):
        logits, st = cstep(st, t)
        assert torch.equal(logits.view(torch.int32), want[s].view(torch.int32)), s
    assert kv.n_cold_blocks == (steps - HOT) // BLK > 0
    for j in range(cfg.n_layers):
        for got, key in zip(kv.layer_caches(j), kv.keys):
            assert torch.equal(got, state[key][j])
    kv2 = KVCacheStore(init_decode_state(cfg, 2, steps, start_pos=0, device="cpu"),
                       hot_window=HOT, block_len=BLK, config=HUFF)
    tstep = make_kv_tiered_serve_step(cfg, params, kv2)
    for s, t in enumerate(toks):
        assert torch.equal(tstep(t).view(torch.int32), want[s].view(torch.int32)), s


def test_mla_evicted_blocks_equal_the_reference():
    """deepseek's latent caches through both stores, fed the same entries
    (the port's own decode): the same cold blobs, block for block, and the
    same accounting.  The blocks are (B, block, 16) and (B, block, 16)
    here; at the published widths (B, 64, 512) and (B, 64, 64)."""
    cfg = get_config("deepseek_v2_236b").reduced()
    jcfg = ref_get_config("deepseek_v2_236b").reduced()
    params = init_params(cfg, 1, device="cpu")
    steps, B = 11, 2
    _, state = _plain(cfg, params, _toks(cfg, steps, B, seed=3), steps)
    ref = RefKVStore(build_model(jcfg).init_decode_state(B, steps, start_pos=0),
                     hot_window=HOT, block_len=BLK, config=REF_HUFF)
    port = KVCacheStore(init_decode_state(cfg, B, steps, start_pos=0, device="cpu"),
                        hot_window=HOT, block_len=BLK, config=HUFF)
    assert port.keys == ref.keys == ("mla_ckv", "mla_kr")
    for s in range(steps):
        news = [state[k][:, :, s:s + 1] for k in port.keys]
        ref.append(*(jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16) for t in news))
        port.append(*news)
    assert port.n_cold_blocks == ref.n_cold_blocks == (steps - HOT) // BLK
    for key in port.keys:
        for j in range(port.n_layers):
            got = [ct.blob for ct in port.cold_blocks(key, j)]
            assert got == [ct.blob for ct in ref._cold[key][j]] and got
            for a, b in zip(port.layer_caches(j), ref.layer_caches(j)):
                assert np.array_equal(a.view(torch.int16).numpy(), np.asarray(b).view(np.int16))
    for name in ("hot_bytes", "cold_comp_bytes", "cold_raw_bytes", "full_cache_bytes"):
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("name", ARCHS)
def test_serve_entry_point_runs(name, capsys):
    out = launch_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "3", "--gen", "4"])
    assert out.shape == (2, 4) and out.dtype == torch.int32
    cfg = get_config(name).reduced()
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 3)).astype(np.int32))
    want, _ = greedy_generate(cfg, init_params(cfg, 0, device="cpu"), prompt, 4)
    assert torch.equal(out, want)
    assert "[serve] generated 2x4 tokens" in capsys.readouterr().out


def _port_config(ref_name):
    """A reference config as the port's ModelConfig, field for field."""
    jcfg = ref_get_config(ref_name).reduced()
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


@pytest.mark.parametrize("ref_name, family", [
    ("mamba2_130m", "ssm"), ("zamba2_7b", "hybrid"), ("qwen2_vl_2b", "vlm"),
])
def test_unported_families_raise(ref_name, family):
    """vlm is ported: its four entry points (the param tree, the decode
    state, the compressed ring and the KV tier) run with the reference's
    shapes.  ssm and hybrid decode in the port; what they still raise is
    what the reference raises: the KV tier for both, and the compressed
    ring for hybrid (its shared attention repeats across groups)."""
    cfg = _port_config(ref_name)
    assert cfg.family == family
    if family == "vlm":
        model = build_model(ref_get_config(ref_name).reduced())
        shapes = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
                  for path, leaf in jax.tree_util.tree_flatten_with_path(
                      model.abstract_params())[0]}
        got = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    got["/".join(path + (k,))] = tuple(v)

        walk(param_shapes(cfg), ())
        assert got == shapes and got["frontend_proj/w"] == (cfg.frontend_dim, cfg.d_model)
        ref_state = jax.eval_shape(lambda: model.init_decode_state(2, 4, start_pos=0))
        state = init_decode_state(cfg, 2, 4, start_pos=0, device="cpu")
        want = {k: tuple(v.shape) for k, v in ref_state.items()}
        assert {k: tuple(v.shape) for k, v in state.items()} == want
        params = init_params(cfg, 0, device="cpu")
        store = CompressedParamStore.from_params(params, HUFF, device="cpu")
        tok = torch.zeros((2, 1), dtype=torch.int32)
        logits, new = make_compressed_serve_step(cfg, store)(state, tok)
        assert logits.shape == (2, 1, cfg.vocab_size)
        assert {k: tuple(v.shape) for k, v in new.items()} == want
        kv = KVCacheStore(init_decode_state(cfg, 2, 4, start_pos=0, device="cpu"))
        assert torch.equal(make_kv_tiered_serve_step(cfg, params, kv)(tok), logits)
        return
    olmoe = get_config("olmoe_1b_7b").reduced()
    store = CompressedParamStore.from_params(init_params(olmoe, 0, device="cpu"), HUFF,
                                             device="cpu")
    kv = KVCacheStore(init_decode_state(olmoe, 2, 4, start_pos=0, device="cpu"))
    assert param_shapes(cfg) and "ssm_state" in init_decode_state(cfg, 2, 4, device="cpu")
    calls = [(lambda: make_kv_tiered_serve_step(cfg, {}, kv), "attention-cache length axis")]
    if family == "hybrid":
        calls.append((lambda: make_compressed_serve_step(cfg, store),
                      "shared_attn params repeat per group"))
    else:
        calls.append((lambda: make_compressed_serve_step(cfg, store, kv_store=kv),
                      "ssm state has no cache-length axis"))
    for call, match in calls:
        with pytest.raises(NotImplementedError, match=match):
            call()


def test_encoder_only_audio_has_no_decode_path():
    """``hubert_xlarge`` (audio) is encoder-only: the reference's
    ``ValueError``, not a missing port."""
    cfg = _port_config("hubert_xlarge")
    assert cfg.family == "audio" and not cfg.has_decode
    olmoe = get_config("olmoe_1b_7b").reduced()
    store = CompressedParamStore.from_params(init_params(olmoe, 0, device="cpu"), HUFF,
                                             device="cpu")
    with pytest.raises(ValueError, match="no decode"):
        make_compressed_serve_step(cfg, store)
    with pytest.raises(ValueError, match="encoder-only"):
        init_decode_state(cfg, 2, 4, device="cpu")
