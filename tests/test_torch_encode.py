"""The port's device encode path against the reference's, byte for byte.

On the CPU the encode kernels' wrappers run their plain versions through
the same code the card runs (``device="cpu"``).  Contract under test:

* ``plane_producer_plain`` (K3) equals the reference's
  ``fused_plane.plane_producer`` (Pallas, interpret mode) in all four
  variants, planes and histograms; ``bitpack_encode_chunks_plain`` (K7)
  equals ``bitpack_encode_chunks_multi``, words and bit counts, with two
  tables, a zero-padded final chunk and a chunk that expands past its
  capacity.  Tolerance: exact equality (integer bit work).
* Blobs of ``backend="device"`` equal the port's host blobs and the
  reference's ``backend="device"`` blobs for bf16, fp16, fp32 and the
  batched pytree, across the knob precedence (``entropy_backend`` None,
  ``"host"``, ``"device"``), the ``hufflib`` coder and fp8 (host path).
* Planes from the device producer need no HUFF-symbol upload; a device
  backend with ``device="cuda"`` and no card raises; a store built with
  the device backend holds the host store's bytes.

Tensors use ``chunk_param_bytes=32768`` (bf16/fp16) and ``65536`` (fp32):
16384-byte plane chunks, the smallest the plane envelope takes, which
keeps the reference's interpret-mode kernels quick.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import zipnn as ref_zipnn
from repro.core.options import CodecOptions as RefOptions
from repro.kernels import bitpack as ref_bitpack
from repro.kernels import fused_plane as ref_fused_plane
from repro_torch import _util
from repro_torch.core import bitlayout, codec, device_entropy, device_plane, huffman, zipnn
from repro_torch.core.options import CodecOptions
from repro_torch.kernels import bitpack_encode_chunks_plain, plane_producer_plain
from repro_torch.serve import CompressedParamStore

NP_DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16, "float32": np.float32}
INTS = {2: np.int16, 4: np.int32}
# chunk_param_bytes giving 16384-byte plane chunks per dtype
CHUNK_PARAMS = {"bfloat16": 32768, "float16": 32768, "float32": 65536}
DEVICE = CodecOptions(backend="device")


def _weights(dtype_name: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.02).astype(NP_DTYPES[dtype_name])


def _tensor(a: np.ndarray) -> torch.Tensor:
    ints = INTS[a.dtype.itemsize]
    return torch.from_numpy(a.view(ints).copy()).view(_util.torch_dtype(a.dtype.name))


def _bits_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[x.element_size()]
    return torch.equal(x.view(ints), y.view(ints))


def _cfg(dtype_name: str, coder: str = "huffman") -> dict:
    return dict(chunk_param_bytes=CHUNK_PARAMS[dtype_name], backend=coder)


# ---------------------------------------------------------------------------
# K3 and K7 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("with_base", [False, True])
def test_plane_producer_plain_matches_reference(itemsize, with_base):
    udt = {2: np.uint16, 4: np.uint32}[itemsize]
    n = ref_fused_plane.ALIGN_ELEMS_U16 if itemsize == 2 else 2 * ref_fused_plane.ALIGN_ELEMS_U32
    chunk = 16384
    rng = np.random.default_rng(itemsize * 10 + with_base)
    # element bits of small weights (skewed exponent bytes), with zero
    # padding at the end as the device path pads a leaf's last chunk
    x = (rng.standard_normal(n) * 0.02).astype(
        ml_dtypes.bfloat16 if itemsize == 2 else np.float32).view(udt)
    x[-1000:] = 0
    base = rng.integers(0, np.iinfo(udt).max, n, dtype=np.uint64).astype(udt) if with_base else None
    planes, hists = ref_fused_plane.plane_producer(
        jnp.asarray(x).reshape(-1, 128),
        None if base is None else jnp.asarray(base).reshape(-1, 128),
        itemsize=itemsize, chunk_elems=chunk, interpret=True,
    )
    ints = INTS[itemsize]
    got_planes, got_hists = plane_producer_plain(
        torch.from_numpy(x.view(ints)),
        None if base is None else torch.from_numpy(base.view(ints)),
        itemsize=itemsize, chunk_elems=chunk,
    )
    assert got_planes.shape == (itemsize, n) and got_planes.dtype == torch.uint8
    for p in range(itemsize):
        np.testing.assert_array_equal(got_planes[p].numpy(), np.asarray(planes[p]).reshape(-1))
    assert got_hists.dtype == torch.int32
    np.testing.assert_array_equal(got_hists.numpy(), np.asarray(hists))


def _skewed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(120, 3, n), 0, 255).astype(np.uint8)


def test_bitpack_plain_matches_reference():
    chunk = 4096
    skewed = _skewed(3 * chunk, seed=1)
    tables = []
    for sample in (skewed, (np.arange(5000) % 7).astype(np.uint8)):
        lens = huffman.code_lengths(np.bincount(sample, minlength=256) + 1)
        tables.append((lens, huffman.canonical_codes(lens)))
    rng = np.random.default_rng(2)
    tail = skewed[2 * chunk :].copy()
    tail[chunk - 777 :] = 0                     # a final chunk, zero-padded
    syms = np.concatenate([
        skewed[: 2 * chunk],                    # two chunks under table 0
        rng.integers(0, 256, chunk).astype(np.uint8),   # table 1: expands
        tail,                                   # table 0, partial
    ])
    pids = np.asarray([0, 0, 1, 0], dtype=np.int32)
    lens = np.stack([t[0] for t in tables]).astype(np.int32)
    codes = np.stack([t[1] for t in tables]).astype(np.int32)
    words, nbits = ref_bitpack.bitpack_encode_chunks_multi(
        jnp.asarray(syms), jnp.asarray(pids), jnp.asarray(lens), jnp.asarray(codes),
        chunk_syms=chunk, interpret=True,
    )
    got_words, got_nbits = bitpack_encode_chunks_plain(
        torch.from_numpy(syms), torch.from_numpy(pids),
        torch.from_numpy(lens), torch.from_numpy(codes), chunk_syms=chunk,
    )
    assert int(got_nbits[2]) > 8 * chunk, "the random chunk must expand past capacity"
    np.testing.assert_array_equal(got_nbits.numpy(), np.asarray(nbits))
    np.testing.assert_array_equal(got_words.numpy().view(np.uint32), np.asarray(words))


# ---------------------------------------------------------------------------
# blobs: port device == port host == reference device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16", "float32"])
def test_device_blobs_match_host_and_reference(dtype_name):
    a = _weights(dtype_name, 40_001, seed=len(dtype_name))
    want = ref_zipnn.compress_array(
        a, ref_zipnn.ZipNNConfig(**_cfg(dtype_name)), options=RefOptions(backend="device")
    ).blob
    cfg = zipnn.ZipNNConfig(**_cfg(dtype_name))
    t = _tensor(a)
    assert zipnn.compress_array(t, cfg).blob == want
    for threads in (0, 4):
        ct = zipnn.compress_array(
            t, cfg, options=CodecOptions(threads=threads, backend="device"), device="cpu"
        )
        assert ct.blob == want, threads
    back = zipnn.decompress_array(ct, cfg)
    assert back.view(torch.uint8).numpy().tobytes() == a.tobytes()
    # the config fields route the same way as the options fields
    cfg_dev = zipnn.ZipNNConfig(**_cfg(dtype_name), plane_backend="device")
    assert zipnn.compress_array(t, cfg_dev, device="cpu").blob == want


def test_bytes_api_device_backend_with_tail_matches_reference():
    raw = _weights("bfloat16", 20_000, seed=9).tobytes() + b"\x07"
    want = ref_zipnn.compress_bytes(
        raw, "bfloat16", ref_zipnn.ZipNNConfig(**_cfg("bfloat16")),
        options=RefOptions(backend="device"),
    )
    got = zipnn.compress_bytes(
        raw, "bfloat16", zipnn.ZipNNConfig(**_cfg("bfloat16")), options=DEVICE, device="cpu"
    )
    assert got == want
    assert zipnn.decompress_bytes(got) == raw


def _route_spies(monkeypatch):
    calls = {"planes": 0, "entropy": 0}
    produce, encode = device_plane.produce_planes_batched, device_entropy.encode_planes

    def spy_produce(*a, **k):
        calls["planes"] += 1
        return produce(*a, **k)

    def spy_encode(*a, **k):
        calls["entropy"] += 1
        return encode(*a, **k)

    monkeypatch.setattr(device_plane, "produce_planes_batched", spy_produce)
    monkeypatch.setattr(device_entropy, "encode_planes", spy_encode)
    return calls


@pytest.mark.parametrize(
    "backend,entropy_backend,coder,routes",
    [
        ("device", None, "huffman", (1, 1)),
        ("device", "host", "huffman", (1, 0)),
        ("host", "device", "huffman", (0, 1)),
        ("host", None, "huffman", (0, 0)),
        ("device", "device", "hufflib", (1, 0)),    # hufflib has no device coder
        ("auto", None, "huffman", (0, 0)),          # a CPU leaf: auto stays on the host
    ],
)
def test_knob_precedence_routes_and_keeps_bytes(
    monkeypatch, backend, entropy_backend, coder, routes
):
    a = _weights("bfloat16", 30_000, seed=4)
    want = ref_zipnn.compress_array(
        a, ref_zipnn.ZipNNConfig(**_cfg("bfloat16", coder)),
        options=RefOptions(backend=backend, entropy_backend=entropy_backend),
    ).blob
    calls = _route_spies(monkeypatch)
    ct = zipnn.compress_array(
        _tensor(a), zipnn.ZipNNConfig(**_cfg("bfloat16", coder)),
        options=CodecOptions(backend=backend, entropy_backend=entropy_backend),
        device="cpu",
    )
    assert ct.blob == want
    assert (calls["planes"], calls["entropy"]) == routes


def test_config_entropy_backend_overrides_the_plane_request(monkeypatch):
    a = _tensor(_weights("bfloat16", 30_000, seed=5))
    calls = _route_spies(monkeypatch)
    cfg = zipnn.ZipNNConfig(**_cfg("bfloat16"), entropy_backend="host")
    host = zipnn.compress_array(a, zipnn.ZipNNConfig(**_cfg("bfloat16"))).blob
    assert zipnn.compress_array(a, cfg, options=DEVICE, device="cpu").blob == host
    assert (calls["planes"], calls["entropy"]) == (1, 0)
    # the options field beats the config field
    zipnn.compress_array(
        a, cfg, options=DEVICE.replace(entropy_backend="device"), device="cpu"
    )
    assert calls["entropy"] == 1


def test_fp8_leaf_stays_on_the_host_path(monkeypatch):
    rng = np.random.default_rng(6)
    a = (rng.standard_normal(20_000) * 0.5).astype(ml_dtypes.float8_e4m3fn)
    want = ref_zipnn.compress_array(
        a, ref_zipnn.ZipNNConfig(chunk_param_bytes=16384, backend="huffman"),
        options=RefOptions(backend="device"),
    ).blob
    t = torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    calls = _route_spies(monkeypatch)
    ct = zipnn.compress_array(
        t, zipnn.ZipNNConfig(chunk_param_bytes=16384, backend="huffman"),
        options=DEVICE, device="cpu",
    )
    assert ct.blob == want
    assert calls["planes"] == 0


def _mixed_tree():
    return {
        "b": {"w": _weights("bfloat16", 3 * 16384 + 5, 1).reshape(-1, 1),
              "g": _weights("bfloat16", 64, 2)},
        "a": {"z": _weights("float32", 20_000, 3), "h": _weights("float16", 17_000, 4)},
        "c": {"w": _weights("bfloat16", 16384, 5), "e": np.zeros(0, ml_dtypes.bfloat16)},
    }


def test_batched_pytree_matches_host_and_reference(monkeypatch):
    tree = _mixed_tree()
    cfg = dict(chunk_param_bytes=32768, backend="huffman")
    want = ref_zipnn.compress_pytree(
        tree, ref_zipnn.ZipNNConfig(**cfg), options=RefOptions(backend="device")
    )
    ttree = _util.tree_map(_tensor, tree)
    host = zipnn.compress_pytree(ttree, zipnn.ZipNNConfig(**cfg))
    calls = _route_spies(monkeypatch)
    got = zipnn.compress_pytree(ttree, zipnn.ZipNNConfig(**cfg), options=DEVICE, device="cpu")
    blobs = [c.blob for c in got["leaves"]]
    assert blobs == [c.blob for c in want["leaves"]]
    assert blobs == [c.blob for c in host["leaves"]]
    assert got["comp_bytes"] == want["comp_bytes"]
    # one K3 batch per dtype in the envelope (bf16, fp16); fp32 at 8192-byte
    # plane chunks is outside it and takes the host plane path
    assert calls["planes"] == 2
    back = zipnn.decompress_pytree(got, zipnn.ZipNNConfig(**cfg))
    for x, y in zip(_util.tree_leaves(back), _util.tree_leaves(ttree)):
        assert x.dtype == y.dtype and _bits_equal(x, y)


def test_batched_probes_correct_each_leafs_padding():
    """Leaves of different pad lengths share one launch; each leaf's
    chunk histograms equal bincounts of its own host planes."""
    layout = bitlayout.layout_for("bfloat16")
    params = codec.CodecParams(chunk_bytes=16384, backend="huffman")
    leaves = [_tensor(_weights("bfloat16", n, n)) for n in (16384, 100, 40_000)]
    produced = device_plane.produce_planes_batched(leaves, layout, params, device="cpu")
    for leaf, (planes, probes) in zip(leaves, produced):
        host = bitlayout.to_planes(leaf.view(torch.uint8).numpy(), layout)
        for p, (plane, probe) in enumerate(zip(planes, probes)):
            np.testing.assert_array_equal(plane, host[p])
            for c in range(probe.n_chunks):
                np.testing.assert_array_equal(
                    probe.chunk_hists[c],
                    np.bincount(host[p][c * 16384 : (c + 1) * 16384], minlength=256),
                )
            np.testing.assert_array_equal(probe.table_hist, codec.table_probe_hist(host[p]))
            assert plane.dev_chunks.shape == (probe.n_chunks, 16384)


def test_planed_array_twin_is_dropped_by_slices():
    layout = bitlayout.layout_for("bfloat16")
    params = codec.CodecParams(chunk_bytes=16384, backend="huffman")
    planes, _ = device_plane.produce_planes(
        _tensor(_weights("bfloat16", 20_000, 7)), layout, params, device="cpu"
    )
    plane = planes[0]
    assert isinstance(plane, device_plane.PlanedArray)
    twin = plane.dev_chunks
    assert twin.shape == (2, 16384) and twin.dtype == torch.uint8
    np.testing.assert_array_equal(twin.reshape(-1)[: plane.size].numpy(), plane)
    assert int(twin.reshape(-1)[plane.size :].abs().sum()) == 0   # zero-padded rows
    assert plane[1:].dev_chunks is None
    assert (plane + 0).dev_chunks is None


def test_device_planes_need_no_symbol_upload():
    a = _tensor(_weights("bfloat16", 50_000, 8))
    cfg = zipnn.ZipNNConfig(**_cfg("bfloat16"))
    device_entropy.reset_transfer_stats()
    dev = zipnn.compress_array(a, cfg, options=DEVICE, device="cpu")
    assert device_entropy.transfer_stats()["symbol_uploads"] == 0
    assert device_entropy.transfer_stats()["payload_uploads"] == 0
    device_entropy.reset_transfer_stats()
    mixed = zipnn.compress_array(
        a, cfg, options=CodecOptions(backend="host", entropy_backend="device"), device="cpu"
    )
    stats = device_entropy.transfer_stats()
    assert stats["symbol_uploads"] > 0 and stats["symbol_bytes"] > 0
    assert dev.blob == mixed.blob


def test_device_backend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _tensor(_weights("bfloat16", 20_000, 9))
    cfg = zipnn.ZipNNConfig(**_cfg("bfloat16"))
    for opts in (DEVICE, CodecOptions(entropy_backend="device")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            zipnn.compress_array(a, cfg, options=opts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zipnn.compress_pytree({"w": a}, cfg, options=DEVICE)


def test_default_cuda_device_resolves_to_an_index(monkeypatch):
    """``"cuda"`` resolves to the current card's index, so it compares equal
    to the ``.device`` of K3's twins and the symbols stay on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert _util.resolve_device("cuda") == torch.device("cuda", 0)
    assert _util.resolve_device(torch.device("cuda")) == torch.device("cuda", 0)
    assert _util.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert _util.resolve_device("cpu") == torch.device("cpu")


def test_store_device_build_holds_the_host_stores_bytes():
    rng = np.random.default_rng(10)
    params = {
        "layers": {
            "w1": _tensor((rng.standard_normal((3, 64, 512)) * 0.02).astype(ml_dtypes.bfloat16)),
            "ln": _tensor((1 + rng.standard_normal((3, 64)) * 0.02).astype(ml_dtypes.bfloat16)),
        },
        "embed": _tensor((rng.standard_normal((32, 64)) * 0.02).astype(ml_dtypes.bfloat16)),
    }
    cfg = zipnn.ZipNNConfig(**_cfg("bfloat16"))
    host = CompressedParamStore.from_params(params, cfg, device="cpu")
    device_entropy.reset_transfer_stats()
    dev = CompressedParamStore.from_params(params, cfg, options=DEVICE, device="cpu")
    assert device_entropy.transfer_stats()["symbol_uploads"] == 0
    for i in range(3):
        assert [c.blob for c in dev.manifest("layers", i)["leaves"]] == [
            c.blob for c in host.manifest("layers", i)["leaves"]
        ]
        got = _util.tree_leaves(dev.decode_layer("layers", i))
        want = _util.tree_leaves(_util.tree_map(lambda t: t[i], params["layers"]))
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int16), w.view(torch.int16))


@pytest.mark.parametrize("backend", ["host", "device"])
def test_empty_tensor_compresses_like_the_reference(backend):
    """An empty tensor's byte view used to raise (a stride-0 view cannot
    change element size); it now gives the reference's empty blob."""
    a = np.zeros((0, 4), ml_dtypes.bfloat16)
    cfg = _cfg("bfloat16")
    want = ref_zipnn.compress_array(
        a, ref_zipnn.ZipNNConfig(**cfg), options=RefOptions(backend=backend)
    ).blob
    t = torch.zeros((0, 4), dtype=torch.bfloat16)
    ct = zipnn.compress_array(
        t, zipnn.ZipNNConfig(**cfg), options=CodecOptions(backend=backend), device="cpu"
    )
    assert ct.blob == want and ct.shape == (0, 4)
    assert zipnn.decompress_array(ct).shape == (0, 4)
