"""The port's device decode driver, payload feed and serving store.

On the CPU the feed runs the kernels' plain versions through the same
code the card runs.  Contract under test: ``PayloadFeed`` / ``ArrayFeed``
give back the original bytes for HUFF, STORE and ZERO chunk mixes; after
the build no decode moves a payload byte host→device (the module's
transfer counters); the compact word layout keeps the resident payload at
the compressed size; and the port's ``CompressedParamStore`` holds
payloads byte-identical to the reference store's for the same params.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import zipnn as ref_zipnn
from repro.models import build_model
from repro.serve import CompressedParamStore as RefStore
from repro_torch import _util, convert
from repro_torch.core import (
    bitlayout, codec, container, device_entropy, device_unplane, huffman, zipnn,
)
from repro_torch.kernels.huffdecode import SYNC_EVERY
from repro_torch.serve import CompressedParamStore

HUFF = zipnn.ZipNNConfig(chunk_param_bytes=1 << 11, backend="huffman")


def _skewed_plane(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = np.r_[np.full(16, 0.05), np.full(240, 0.2 / 240)]
    return rng.choice(256, p=p, size=n).astype(np.uint8)


def _bf16(shape, seed, scale=0.02):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16)


def _parsed(blob):
    meta, mv = container.unpack_stream(blob)
    payloads = [
        [container.payload_view(meta, mv, p, c) for c in range(len(meta.entries[p]))]
        for p in range(meta.n_planes)
    ]
    return meta, payloads


def test_decode_planes_mixed_methods_match_host_codec():
    cb = 1024
    params = codec.CodecParams(chunk_bytes=cb, backend="huffman")
    rng = np.random.default_rng(11)
    planes = [
        np.concatenate([
            rng.integers(0, 256, cb, dtype=np.uint8),     # STORE
            np.zeros(cb, dtype=np.uint8),                 # ZERO
            _skewed_plane(cb + cb // 3, seed=5),          # HUFF + partial chunk
        ]),
        _skewed_plane(2 * cb, seed=6),
    ]
    outs = [codec.compress_plane(p, params) for p in planes]
    entries = [o[0] for o in outs]
    methods = {e.method for pe in entries for e in pe}
    assert {codec.Method.HUFF, codec.Method.STORE, codec.Method.ZERO} <= methods
    got = device_entropy.decode_planes(
        entries, [o[1] for o in outs], [o[2] for o in outs], params, device="cpu"
    )
    for g, p in zip(got, planes):
        assert np.array_equal(g.numpy(), p)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_array_feed_round_trip_with_zero_decode_uploads(dtype):
    leaf = _bf16((48, 40), seed=1, scale=0.3).to(dtype)
    ct = zipnn.compress_array(leaf, HUFF)
    device_entropy.reset_transfer_stats()
    feed = zipnn.build_array_feed(ct, HUFF, device="cpu")
    built = device_entropy.transfer_stats()
    assert built["payload_uploads"] >= 1
    device_entropy.reset_transfer_stats()
    for _ in range(3):
        out = feed.decode()
        assert out.dtype == dtype and out.shape == leaf.shape
        assert torch.equal(out.view(torch.uint8), leaf.view(torch.uint8))
    assert device_entropy.transfer_stats()["payload_uploads"] == 0
    back = zipnn.decompress_array(ct, HUFF, device_resident=True, device="cpu")
    assert torch.equal(back.view(torch.uint8), leaf.view(torch.uint8))


def test_feed_holds_compressed_bytes_only():
    """Every resident byte is counted — compact words (each payload padded
    to whole words only, not to the raw chunk capacity), the splice, one
    int16 LUT row per plane with HUFF chunks, the per-chunk index arrays,
    the sync index — and the total stays below the leaf's raw size."""
    leaf = _bf16((512, 512), seed=2)
    ct = zipnn.compress_array(leaf, HUFF)
    feed = zipnn.build_array_feed(ct, HUFF, device="cpu")
    meta, payloads = _parsed(ct.blob)
    huff = [(p, c) for p, pe in enumerate(meta.entries) for c, e in enumerate(pe)
            if e.method == codec.Method.HUFF]
    assert huff
    words = sum(-(-len(payloads[p][c]) // 4) * 4 for p, c in huff)
    other = sum(e.raw_len for pe in meta.entries for e in pe if e.method != codec.Method.HUFF)
    huff_planes = sorted({p for p, _ in huff})
    width = max(int(huffman.unpack_table(meta.tables[p]).max()) for p in huff_planes)
    luts = len(huff_planes) * (1 << width) * 2
    index = len(huff) * (8 + 4 + 4 + 8) + 8        # word_off, lut rows, counts, out_off
    # the sync index: one int32 cursor per SYNC_EVERY symbols of each HUFF
    # chunk, and its int64 per-chunk offsets
    sync = 4 * sum(-(-meta.entries[p][c].raw_len // SYNC_EVERY) for p, c in huff)
    sync += 8 * (len(huff) + 1)
    assert feed.device_bytes == words + other + luts + index + sync
    assert feed.device_bytes < leaf.numel() * 2
    args = feed.launch_args()
    assert tuple(args["luts"].shape) == (len(huff_planes), 1 << width)
    assert feed.n_launches == {"huffdecode_chunks": 1, "plane_consumer": 1}


def test_feed_build_rejects_corruption():
    leaf = _bf16((64, 64), seed=3)
    ct = zipnn.compress_array(leaf, HUFF)
    meta, _ = _parsed(ct.blob)
    bad = bytearray(ct.blob)
    bad[meta.payload_offsets[0][0] + 1] ^= 0x08
    with pytest.raises(IOError, match="CRC"):
        zipnn.build_array_feed(zipnn.CompressedTensor(bytes(bad), ct.dtype, ct.shape),
                               HUFF, device="cpu")


def test_feed_ineligible_leaves_return_none():
    assert zipnn.build_array_feed(zipnn.compress_array(torch.arange(64, dtype=torch.uint8)),
                                  device="cpu") is None
    assert zipnn.build_array_feed(zipnn.compress_array(torch.zeros(0, dtype=torch.bfloat16)),
                                  device="cpu") is None
    # ...and such leaves still decode on the device path's terms
    ct = zipnn.compress_array(torch.arange(64, dtype=torch.uint8))
    out = zipnn.decompress_array(ct, device_resident=True, device="cpu")
    assert torch.equal(out, torch.arange(64, dtype=torch.uint8))


def test_consume_planes_batched_matches_per_tensor():
    layout = bitlayout.layout_for("bfloat16")
    leaves = [_bf16((n,), seed=n) for n in (17, 300, 64)]
    planes = [
        [torch.from_numpy(p) for p in bitlayout.to_planes(t.view(torch.uint8).numpy(), layout)]
        for t in leaves
    ]
    bases = [None, leaves[1].view(torch.int16), None]
    outs = device_unplane.consume_planes_batched(planes, layout, bases)
    for out, t, b in zip(outs, leaves, bases):
        want = t.view(torch.int16) if b is None else t.view(torch.int16) ^ b
        assert torch.equal(out, want)


def test_lut_cache_is_bounded():
    info = device_entropy._stacked_luts_cached.cache_info()
    assert info.maxsize == device_entropy.LUT_CACHE_SIZE == 64


# ---------------------------------------------------------------------------
# the serving store against the reference store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_params():
    cfg = ref_get_config("repro_gpt_100m").reduced()
    leaves, treedef = jax.tree_util.tree_flatten(build_model(cfg).abstract_params())
    rng = np.random.default_rng(0)
    np_leaves = [(rng.standard_normal(l.shape) * 0.02).astype(np.dtype(l.dtype)) for l in leaves]
    return jax.tree_util.tree_unflatten(treedef, np_leaves)


def test_store_payloads_byte_identical_to_reference(reduced_params):
    kw = dict(chunk_param_bytes=1 << 12, backend="huffman")
    ref = RefStore.from_params(reduced_params, ref_zipnn.ZipNNConfig(**kw))
    tp = convert.params_from_numpy(reduced_params, device="cpu")
    port = CompressedParamStore.from_params(tp, zipnn.ZipNNConfig(**kw), device="cpu")
    assert port.stack_keys == ref.stack_keys == ("layers",)
    for i in range(ref.n_layers("layers")):
        want = [ct.blob for ct in ref._stacks["layers"][i]["leaves"]]
        got = [ct.blob for ct in port.manifest("layers", i)["leaves"]]
        assert got == want, i
    assert port.comp_bytes == ref.comp_bytes and port.raw_bytes == ref.raw_bytes
    assert port.ratio_pct == pytest.approx(ref.ratio_pct, abs=0)
    assert port.static_bytes == ref.static_bytes
    assert port.footprint_bytes(2) == ref.footprint_bytes(2)


def test_store_decodes_every_layer_bit_exactly(reduced_params):
    tp = convert.params_from_numpy(reduced_params, device="cpu")
    for feed in (True, False):
        store = CompressedParamStore.from_params(tp, HUFF, payload_feed=feed, device="cpu")
        assert (store.device_payload_bytes > 0) == feed
        at_rest = store.device_payload_bytes if feed else store.comp_bytes
        assert store.footprint_bytes(2) == (
            at_rest + store.static_bytes + 2 * store.max_layer_raw_bytes
        )
        for i in range(store.n_layers("layers")):
            got = _util.tree_leaves(store.decode_layer("layers", i))
            want = _util.tree_leaves(_util.tree_map(lambda a, i=i: a[i], tp["layers"]))
            for g, w in zip(got, want):
                assert torch.equal(g.view(torch.int16), w.view(torch.int16))
            store.release("layers", i)
        assert store.peak_resident == 1 and store.resident_count == 0


def test_params_from_numpy_is_bit_exact(reduced_params):
    tp = convert.params_from_numpy(reduced_params, device="cpu")
    for a, t in zip(jax.tree_util.tree_leaves(reduced_params), _util.tree_leaves(tp)):
        assert a.dtype == ml_dtypes.bfloat16 and t.dtype == torch.bfloat16
        assert t.view(torch.int16).numpy().tobytes() == a.tobytes()
