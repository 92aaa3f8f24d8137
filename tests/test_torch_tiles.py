"""The per-tile serving ring: ``CompressedParamStore.tile_leaf_ids`` /
``decode_layer_tile`` / ``release_tile`` / ``layer_unflatten`` and
``make_compressed_serve_step(tiles=...)``, against the reference's
geometry and the port's own plain decode step.

The model is ``granite_20b`` at ``reduced()`` size (15 leaves a layer:
MQA, layernorm, GELU, QKV bias, learned positions), weights from a numpy
seed.  Tolerance: none — the tiled ring is bit-identical to
:func:`repro_torch.models.decode_step`, the contract the reference keeps
for itself.  512-byte chunks keep the plain Huffman decode loop short on
the CPU.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import zipnn as ref_zipnn
from repro.models import build_model
from repro.serve import CompressedParamStore as RefStore
from repro_torch import _util, convert
from repro_torch.configs import get_config
from repro_torch.core import device_entropy, zipnn
from repro_torch.models import init_decode_state
from repro_torch.serve import (
    CompressedParamStore,
    greedy_generate,
    make_compressed_serve_step,
    make_serve_step,
)

HUFF = zipnn.ZipNNConfig(chunk_param_bytes=512, backend="huffman")
N_LEAVES = 15


@pytest.fixture(scope="module")
def setup():
    jcfg = ref_get_config("granite_20b").reduced()
    model = build_model(jcfg)
    leaves, treedef = jax.tree_util.tree_flatten(model.abstract_params())
    rng = np.random.default_rng(0)
    np_leaves = [(rng.standard_normal(l.shape) * 0.02).astype(np.dtype(l.dtype)) for l in leaves]
    nptree = jax.tree_util.tree_unflatten(treedef, np_leaves)
    cfg = get_config("granite_20b").reduced()
    params = convert.params_from_numpy(nptree, device="cpu")
    store = CompressedParamStore.from_params(params, HUFF, payload_feed=True, device="cpu")
    ref_store = RefStore.from_params(
        nptree, ref_zipnn.ZipNNConfig(chunk_param_bytes=512, backend="huffman")
    )
    return cfg, params, store, ref_store


def _lockstep(cfg, params, cstep, steps=3, seed=0):
    """Plain step and the ring on the same tokens: logits and every state
    leaf bit for bit at every step."""
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


@pytest.mark.parametrize("tiles", [1, 2, N_LEAVES, N_LEAVES + 3])
def test_tile_leaf_ids_match_reference(setup, tiles):
    _, _, store, ref_store = setup
    assert store.n_leaves("layers") == ref_store.n_leaves("layers") == N_LEAVES
    got = [store.tile_leaf_ids("layers", t, tiles) for t in range(tiles + 2)]
    want = [ref_store.tile_leaf_ids("layers", t, tiles) for t in range(tiles + 2)]
    assert got == want
    assert [j for r in got for j in r] == list(range(N_LEAVES))   # contiguous, complete


@pytest.mark.parametrize("tiles", [1, 2, N_LEAVES, N_LEAVES + 3])
def test_tiled_ring_bit_identical_to_plain_step(setup, tiles):
    cfg, params, store, _ = setup
    store.reset_peak()
    device_entropy.reset_transfer_stats()
    ring = 2
    cstep = make_compressed_serve_step(cfg, store, ring=ring, tiles=tiles)
    assert cstep.tiles == tiles and cstep.ring == ring
    assert _lockstep(cfg, params, cstep)
    assert 1 <= store.peak_resident <= ring * tiles
    assert store.resident_count == 0
    assert device_entropy.transfer_stats()["payload_uploads"] == 0


def test_tiles_without_prefetch_hold_one_layer(setup):
    cfg, params, store, _ = setup
    store.reset_peak()
    cstep = make_compressed_serve_step(cfg, store, prefetch=False, tiles=4)
    assert _lockstep(cfg, params, cstep, steps=2)
    assert store.peak_resident <= 4


def test_tiles_reassemble_decode_layer(setup):
    """The tiles of a layer, put back together, are decode_layer's leaves."""
    _, _, store, _ = setup
    for tiles in (2, 4):
        arrays = {}
        for t in range(tiles):
            part = store.decode_layer_tile("layers", 1, t, tiles)
            assert sorted(part) == list(store.tile_leaf_ids("layers", t, tiles))
            arrays.update(part)
        tree = store.layer_unflatten("layers", 1, [arrays[k] for k in sorted(arrays)])
        whole = store.decode_layer("layers", 1)
        assert store.resident_count == tiles + 1
        for a, b in zip(_util.tree_leaves(tree), _util.tree_leaves(whole)):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        for t in range(tiles):
            store.release_tile("layers", 1, t, tiles)
        store.release("layers", 1)
        assert store.resident_count == 0
    store.reset_peak()


def test_tiled_ring_without_feeds_generates_like_plain(setup):
    cfg, params, _, _ = setup
    store = CompressedParamStore.from_params(params, HUFF, device="cpu")
    assert store.device_payload_bytes == 0
    prompt = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
    )
    la, lb = [], []
    ta, _ = greedy_generate(cfg, params, prompt, 2, logits_out=la)
    tb, _ = greedy_generate(cfg, None, prompt, 2, logits_out=lb,
                            serve_step=make_compressed_serve_step(cfg, store, tiles=3))
    assert torch.equal(ta, tb) and len(la) == len(lb) == 4
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert store.peak_resident <= 2 * 3


def test_tiles_validation(setup):
    cfg, _, store, _ = setup
    with pytest.raises(ValueError, match="tiles"):
        make_compressed_serve_step(cfg, store, tiles=0)
    with pytest.raises(ValueError, match="tiles"):
        make_compressed_serve_step(cfg, store, tiles=-1)
    with pytest.raises(ValueError, match="ring"):
        make_compressed_serve_step(cfg, store, ring=0, tiles=2)
    with pytest.raises(ValueError, match="layers"):
        make_compressed_serve_step(dataclasses.replace(cfg, n_layers=3), store, tiles=2)
