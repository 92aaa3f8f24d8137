"""The KV tier (``repro_torch.serve.kvcache.KVCacheStore``,
``make_kv_tiered_serve_step``, ``make_compressed_serve_step(kv_store=)``)
against the reference's store and the port's own plain decode step, and
the serving entry point (``python -m repro_torch.launch.serve``).

* Evicted blocks: byte-identical blobs to the reference's
  ``KVCacheStore`` fed the same entries through ``append``, and every
  accounting property equal to the reference's.
* Decode: bit-identical logits to the untiered
  :func:`repro_torch.models.decode_step`, with evictions happening.
* Rejections: the reference's.

The model is ``granite_20b`` at ``reduced()`` size (MQA: one KV head).
Small windows (``hot_window=3``, ``block_len=2``) make a short decode cross
several eviction boundaries, as in ``tests/test_kvcache.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import zipnn as ref_zipnn
from repro.models import build_model
from repro.serve import KVCacheStore as RefKVStore
from repro_torch import convert
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import zipnn
from repro_torch.launch import serve as launch_serve
from repro_torch.models import decode_step, init_decode_state
from repro_torch.models.model import init_params
from repro_torch.serve import (
    CompressedParamStore,
    KVCacheStore,
    greedy_generate,
    make_compressed_serve_step,
    make_kv_tiered_serve_step,
)

HOT, BLK = 3, 2
HUFF = zipnn.ZipNNConfig(chunk_param_bytes=512, backend="huffman")
REF_HUFF = ref_zipnn.ZipNNConfig(chunk_param_bytes=512, backend="huffman")


@pytest.fixture(scope="module")
def granite():
    cfg = get_config("granite_20b").reduced()
    jcfg = ref_get_config("granite_20b").reduced()
    params = init_params(cfg, 0, device="cpu")
    return cfg, jcfg, params


def _news(cfg, rng, steps, B=2):
    """Per step, stacked (L, B, 1, G, hd) bf16 entries for both keys."""
    shape = (steps, 2, cfg.n_layers, B, 1, cfg.n_kv_heads, cfg.head_dim)
    a = rng.standard_normal(shape).astype(np.float32)
    return convert.params_from_numpy(
        {"a": (a * 0.05).astype(jnp.bfloat16.dtype)}, device="cpu")["a"]


@pytest.mark.parametrize("config, ref_config", [
    (HUFF, REF_HUFF),
    (zipnn.DEFAULT, ref_zipnn.DEFAULT),
], ids=["huffman", "default"])
def test_evicted_blobs_and_accounting_equal_the_reference(granite, config, ref_config):
    cfg, jcfg, _ = granite
    B, length, steps = 2, 12, 11
    model = build_model(jcfg)
    ref = RefKVStore(model.init_decode_state(B, length, start_pos=0),
                     hot_window=HOT, block_len=BLK, config=ref_config)
    port = KVCacheStore(init_decode_state(cfg, B, length, start_pos=0, device="cpu"),
                        hot_window=HOT, block_len=BLK, config=config)
    assert port.keys == ref.keys == ("kv_k", "kv_v")
    news = _news(cfg, np.random.default_rng(5), steps, B)
    for s in range(steps):
        k, v = news[s, 0], news[s, 1]
        ref.append(*(jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16) for t in (k, v)))
        port.append(k, v)
        assert port.pos == ref.pos and port.cold_len == ref.cold_len
    assert port.n_cold_blocks == ref.n_cold_blocks == (steps - HOT) // BLK
    for key in port.keys:
        for j in range(port.n_layers):
            got = [ct.blob for ct in port.cold_blocks(key, j)]
            want = [ct.blob for ct in ref._cold[key][j]]
            assert got == want and len(got) == port.n_cold_blocks
            for a, b in zip(port.layer_caches(j), (ref.layer_caches(j))):
                assert np.array_equal(a.view(torch.int16).numpy(), np.asarray(b).view(np.int16))
    for name in ("hot_bytes", "cold_comp_bytes", "cold_raw_bytes", "full_cache_bytes",
                 "peak_hot_positions", "peak_inflight_blocks", "n_layers", "length"):
        assert getattr(port, name) == getattr(ref, name), name
    for inflight in (0, 1, 2):
        assert port.resident_bytes(inflight) == ref.resident_bytes(inflight)


def _plain_logits(cfg, params, toks, length):
    state = init_decode_state(cfg, toks.shape[1], length, start_pos=0, device="cpu")
    out = []
    for t in toks:
        logits, state = decode_step(cfg, params, state, t)
        out.append(logits)
    return out, state


def test_tiered_step_bit_identical_to_untiered(granite):
    cfg, _, params = granite
    steps, B = 12, 2
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32))
    want, state = _plain_logits(cfg, params, toks, steps)
    store = KVCacheStore(init_decode_state(cfg, B, steps, start_pos=0, device="cpu"),
                         hot_window=HOT, block_len=BLK, config=HUFF)
    tstep = make_kv_tiered_serve_step(cfg, params, store)
    assert tstep.kv_store is store
    for s, t in enumerate(toks):
        assert torch.equal(tstep(t).view(torch.int32), want[s].view(torch.int32)), s
    assert store.n_cold_blocks > 0 and store.peak_hot_positions <= HOT + BLK
    for j in range(cfg.n_layers):               # the tier is invisible
        for got, key in zip(store.layer_caches(j), ("kv_k", "kv_v")):
            assert torch.equal(got, state[key][j])
    assert store.pos == int(state["pos"])


@pytest.mark.parametrize("tiles", [1, 2])
def test_ring_with_kv_store_bit_identical_to_untiered(granite, tiles):
    cfg, _, params = granite
    steps, B = 10, 2
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32))
    want, _ = _plain_logits(cfg, params, toks, steps)
    kv = KVCacheStore(init_decode_state(cfg, B, steps, start_pos=0, device="cpu"),
                      hot_window=HOT, block_len=BLK, config=HUFF)
    wstore = CompressedParamStore.from_params(params, HUFF, payload_feed=True, device="cpu")
    cstep = make_compressed_serve_step(cfg, wstore, ring=2, tiles=tiles, kv_store=kv)
    assert cstep.kv_store is kv
    state = {"pos": torch.tensor(0, dtype=torch.int32)}
    for s, t in enumerate(toks):
        logits, state = cstep(state, t)
        assert torch.equal(logits.view(torch.int32), want[s].view(torch.int32)), s
    assert int(state["pos"]) == kv.pos == steps
    assert kv.n_cold_blocks > 0 and kv.cold_comp_bytes > 0
    assert wstore.peak_resident <= 2 * tiles and wstore.comp_bytes < wstore.raw_bytes


def test_ring_with_kv_store_through_greedy_generate(granite):
    cfg, _, params = granite
    prompt = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 5)).astype(np.int32))
    la, lb = [], []
    ta, _ = greedy_generate(cfg, params, prompt, 4, logits_out=la)
    kv = KVCacheStore(init_decode_state(cfg, 2, 9, start_pos=0, device="cpu"),
                      hot_window=HOT, block_len=BLK, config=HUFF)
    wstore = CompressedParamStore.from_params(params, HUFF, payload_feed=True, device="cpu")
    tb, _ = greedy_generate(cfg, None, prompt, 4, logits_out=lb, serve_step=make_compressed_serve_step(
        cfg, wstore, tiles=4, kv_store=kv))
    assert torch.equal(ta, tb) and all(torch.equal(a, b) for a, b in zip(la, lb))
    assert kv.n_cold_blocks == (9 - HOT) // BLK


def _state(cfg, length=10):
    return init_decode_state(cfg, 2, length, start_pos=0, device="cpu")


def test_rejects_nonempty_start(granite):
    cfg, _, _ = granite
    state = dict(_state(cfg), pos=torch.tensor(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="start_pos=0"):
        KVCacheStore(state, hot_window=HOT, block_len=BLK)


@pytest.mark.parametrize("hot_window, block_len", [(0, BLK), (HOT, 0), (-1, BLK), (HOT, -2)])
def test_rejects_bad_windows(granite, hot_window, block_len):
    cfg, _, _ = granite
    with pytest.raises(ValueError):
        KVCacheStore(_state(cfg), hot_window=hot_window, block_len=block_len)


def test_rejects_state_without_caches(granite):
    with pytest.raises(ValueError, match="no stacked attention caches"):
        KVCacheStore({"pos": torch.tensor(0)}, hot_window=HOT, block_len=BLK)


def test_rejects_ssm_state(granite):
    cfg, _, params = granite
    state = dict(_state(cfg), ssm_state=torch.zeros(2, 2, 4, 8, 16))
    with pytest.raises(NotImplementedError):
        KVCacheStore(state, hot_window=HOT, block_len=BLK)
    kv = KVCacheStore(_state(cfg), hot_window=HOT, block_len=BLK)
    ssm = dataclasses.replace(cfg, family="ssm")
    with pytest.raises(NotImplementedError):
        make_kv_tiered_serve_step(ssm, params, kv)
    store = CompressedParamStore.from_params(params, HUFF, device="cpu")
    with pytest.raises(NotImplementedError):
        make_compressed_serve_step(ssm, store, kv_store=kv)


def test_no_wraparound_past_length(granite):
    cfg, _, params = granite
    store = KVCacheStore(_state(cfg, length=4), hot_window=HOT, block_len=BLK)
    tstep = make_kv_tiered_serve_step(cfg, params, store)
    rng = np.random.default_rng(3)
    for _ in range(4):
        tstep(torch.from_numpy(rng.integers(0, 100, (2, 1)).astype(np.int32)))
    with pytest.raises(ValueError, match="full"):
        tstep(torch.from_numpy(rng.integers(0, 100, (2, 1)).astype(np.int32)))


def test_layer_count_mismatch_rejected(granite):
    cfg, _, params = granite
    deeper = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
    kv = KVCacheStore(_state(deeper), hot_window=HOT, block_len=BLK)
    with pytest.raises(ValueError, match="layers"):
        make_kv_tiered_serve_step(cfg, params, kv)
    store = CompressedParamStore.from_params(params, HUFF, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        make_compressed_serve_step(cfg, store, kv_store=kv)


def test_mla_key_pair_is_the_references():
    from repro.serve import kvcache as ref_kvcache
    from repro_torch.serve import kvcache

    assert kvcache.MLA_KEYS == ref_kvcache.MLA_KEYS and kvcache.GQA_KEYS == ref_kvcache.GQA_KEYS
    state = {"pos": torch.tensor(0), "mla_ckv": torch.zeros(2, 2, 8, 16, dtype=torch.bfloat16),
             "mla_kr": torch.zeros(2, 2, 8, 4, dtype=torch.bfloat16)}
    store = KVCacheStore(state, hot_window=HOT, block_len=BLK)
    assert store.keys == ("mla_ckv", "mla_kr")
    assert store.full_cache_bytes == 2 * 2 * 8 * (16 + 4) * 2


def test_serve_entry_point_restores_a_checkpoint(granite, tmp_path, capsys):
    """``main([... "--device", "cpu"])`` restores a reduced granite_20b
    checkpoint the port's manager wrote and generates greedy_generate's
    tokens on the same params."""
    cfg, _, _ = granite
    params = init_params(cfg, 7, device="cpu")
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=False, device="cpu"))
    mgr.save(3, {"params": params})
    out = launch_serve.main(["--arch", "granite_20b", "--reduced", "--ckpt-dir", str(tmp_path),
                             "--batch", "2", "--prompt-len", "4", "--gen", "5", "--seed", "1",
                             "--device", "cpu"])
    text = capsys.readouterr().out
    assert "restored step 3" in text and "first sequence:" in text
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 4)).astype(np.int32))
    want, _ = greedy_generate(cfg, params, prompt, 5)
    assert out.shape == (2, 5) and torch.equal(out, want)


def test_serve_entry_point_random_init(granite, capsys):
    cfg, _, _ = granite
    out = launch_serve.main(["--arch", "granite_20b", "--reduced", "--batch", "2",
                             "--prompt-len", "3", "--gen", "2", "--device", "cpu"])
    assert "random init" in capsys.readouterr().out
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 3)).astype(np.int32))
    want, _ = greedy_generate(cfg, init_params(cfg, 0, device="cpu"), prompt, 2)
    assert torch.equal(out, want)
