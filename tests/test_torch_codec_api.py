"""The rest of the port's codec API against the reference's.

Contract under test, with exact equality as the tolerance:
``ZipNNSession`` gives the module functions' bytes; ``compressed_size``
and ``ratio`` the reference's numbers; the batched ``decompress_pytree``
(one K2 launch per layout window, through ``consume_planes_batched``)
restores every leaf as decoding it alone does; ``decompress_bytes`` on the
device route (``decode_planes`` for K1, ``consume_planes`` for K2; on the
CPU their plain versions) gives the host route's bytes; the ``"auto"``
default writes the reference's default bytes, keeps CPU tensors on the
host and sends host bytes (byte streams, file frames) to a present card,
under the one rule of ``resolve_backend``; and the fp8 e4m3fn / e5m2, int8, bool and fp64 layouts are
byte-identical to the reference, in blobs and in ZNS1 file headers.
"""

import io

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import zipnn as ref_zipnn
from repro_torch import _util
from repro_torch.core import bitlayout, device_entropy, device_unplane, engine, zipnn
from repro_torch.core.options import CodecOptions, ZipNNSession, resolve_backend

CFG = dict(chunk_param_bytes=1 << 12, backend="huffman")
NP_DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16, "float32": np.float32}


def _weights(dtype_name: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scale = 0.3 if dtype_name == "float32" else 0.02
    return (rng.standard_normal(shape) * scale).astype(NP_DTYPES[dtype_name])


def _tensor(a: np.ndarray) -> torch.Tensor:
    u8 = torch.from_numpy(np.ascontiguousarray(a).reshape(-1).view(np.uint8).copy())
    return u8.view(_util.torch_dtype(a.dtype.name)).reshape(a.shape)


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, spy)


def test_session_matches_the_module_functions(tmp_path):
    cfg = zipnn.ZipNNConfig(**CFG)
    opts = CodecOptions(threads=4, backend="device")
    s = ZipNNSession(cfg, opts, device="cpu")
    a = _tensor(_weights("bfloat16", (50, 70), 1))
    b = _tensor(_weights("bfloat16", (50, 70), 2))
    raw = _bits(a)
    kw = dict(options=opts, device="cpu")
    assert s.compress_bytes(raw, "bfloat16") == zipnn.compress_bytes(raw, "bfloat16", cfg, **kw)
    assert s.decompress_bytes(s.compress_bytes(raw, "bfloat16")) == raw
    ct = s.compress_array(a)
    assert ct.blob == zipnn.compress_array(a, cfg, **kw).blob
    assert _bits(s.decompress_array(ct)) == raw
    assert s.decompress_array(ct, device_resident=True).device.type == "cpu"
    tree = {"a": a, "b": [b]}
    m = s.compress_pytree(tree)
    assert [c.blob for c in m["leaves"]] == [
        c.blob for c in zipnn.compress_pytree(tree, cfg, **kw)["leaves"]]
    assert [_bits(t) for t in _util.tree_leaves(s.decompress_pytree(m))] == [raw, _bits(b)]
    d = s.delta_compress(a, b)
    assert d.blob == zipnn.delta_compress(a, b, cfg, **kw).blob
    assert [c.blob for c in s.delta_compress_batched([a], [b])] == [d.blob]
    assert _bits(s.delta_decompress(d, b)) == raw
    (tmp_path / "w.raw").write_bytes(raw)
    s.compress_file(str(tmp_path / "w.raw"), str(tmp_path / "w.znns"), "bfloat16",
                    window_bytes=1 << 12)
    engine.compress_file(str(tmp_path / "w.raw"), str(tmp_path / "m.znns"), "bfloat16", cfg,
                         window_bytes=1 << 12, **kw)
    assert (tmp_path / "w.znns").read_bytes() == (tmp_path / "m.znns").read_bytes()
    assert s.decompress_file(str(tmp_path / "w.znns"), str(tmp_path / "w.back")) == len(raw)
    assert (tmp_path / "w.back").read_bytes() == raw


def test_compressed_size_and_ratio_match_reference():
    a = _weights("bfloat16", (64, 64), 3)
    tree = {"w": a, "b": _weights("float32", (64,), 4)}
    want = ref_zipnn.compress_pytree(tree, ref_zipnn.ZipNNConfig(**CFG))
    got = zipnn.compress_pytree(_util.tree_map(_tensor, tree), zipnn.ZipNNConfig(**CFG))
    assert zipnn.compressed_size(got) == ref_zipnn.compressed_size(want)
    assert zipnn.compressed_size(got["leaves"][1]) == ref_zipnn.compressed_size(want["leaves"][1])
    for raw, comp in ((got["raw_bytes"], got["comp_bytes"]), (0, 0), (10, 3)):
        assert zipnn.ratio(raw, comp) == ref_zipnn.ratio(raw, comp)


@pytest.mark.parametrize("device_resident", [False, True])
def test_batched_decompress_pytree_matches_leaf_by_leaf(monkeypatch, device_resident):
    """bf16 and fp32 leaves (two layout groups), an empty leaf, a tail-free
    int8 leaf the card cannot un-plane: one batched K2 call per group, and
    every leaf equal to its own decode."""
    tree = {
        "a": _tensor(_weights("bfloat16", (40, 50), 5)),
        "b": _tensor(_weights("bfloat16", (3, 7), 6)),
        "c": _tensor(_weights("float32", (30, 20), 7)),
        "d": _tensor(_weights("float32", (33,), 8)),
        "e": torch.zeros((0, 4), dtype=torch.bfloat16),
        "f": torch.arange(-50, 50, dtype=torch.int8),
    }
    cfg = zipnn.ZipNNConfig(**CFG)
    m = zipnn.compress_pytree(tree, cfg)
    calls = []
    _spy(monkeypatch, device_unplane, "consume_planes_batched", calls)
    opts = CodecOptions(backend="device", device_resident=device_resident)
    back = zipnn.decompress_pytree(m, cfg, options=opts, device="cpu")
    assert calls == ["consume_planes_batched"] * 2
    for k, t in tree.items():
        alone = zipnn.decompress_array(m["leaves"][sorted(tree).index(k)], cfg)
        assert back[k].dtype == t.dtype and back[k].shape == t.shape, k
        assert _bits(back[k]) == _bits(t) == _bits(alone), k


def test_batched_decompress_pytree_splits_at_the_batch_cap(monkeypatch):
    from repro_torch.core import device_plane

    cap = 5000
    monkeypatch.setattr(device_plane, "MAX_BATCH_BYTES", cap)
    tree = {f"w{i}": _tensor(_weights("bfloat16", (40, 30), 10 + i)) for i in range(4)}
    m = zipnn.compress_pytree(tree, zipnn.ZipNNConfig(**CFG))
    windows = []
    batched = device_unplane.consume_planes_batched

    def spy(leaf_planes, layout, *a, **k):
        windows.append(sum(p[0].numel() * layout.itemsize for p in leaf_planes))
        return batched(leaf_planes, layout, *a, **k)

    monkeypatch.setattr(device_unplane, "consume_planes_batched", spy)
    back = zipnn.decompress_pytree(
        m, zipnn.ZipNNConfig(**CFG), options=CodecOptions(backend="device"), device="cpu"
    )
    assert windows == [4800, 4800]                 # 2,400 B a leaf: two leaves a window
    assert all(w <= cap for w in windows)          # split before the cap, never past it
    assert all(_bits(back[k]) == _bits(t) for k, t in tree.items())


@pytest.mark.parametrize(
    "backend,entropy_backend,routes",
    [
        ("device", None, ["decode_planes", "consume_planes"]),
        ("device", "host", ["consume_planes"]),
        ("host", "device", ["decode_planes"]),
        ("host", None, []),
        ("auto", None, []),                    # device="cpu" is no card
    ],
)
def test_decompress_bytes_device_route_matches_host(monkeypatch, backend, entropy_backend, routes):
    raw = _weights("bfloat16", 30_001, 9).tobytes() + b"\x05"
    blob = ref_zipnn.compress_bytes(raw, "bfloat16", ref_zipnn.ZipNNConfig(**CFG))
    calls = []
    _spy(monkeypatch, device_entropy, "decode_planes", calls)
    _spy(monkeypatch, device_unplane, "consume_planes", calls)
    out = zipnn.decompress_bytes(
        blob, zipnn.ZipNNConfig(**CFG),
        options=CodecOptions(threads=4, backend=backend, entropy_backend=entropy_backend),
        device="cpu",
    )
    assert out == raw
    assert calls == routes


def test_decompress_bytes_on_a_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = zipnn.compress_bytes(_weights("bfloat16", 5000, 1).tobytes(), "bfloat16",
                                zipnn.ZipNNConfig(**CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zipnn.decompress_bytes(blob, options=CodecOptions(backend="device"))
    # "auto" with no card decodes on the host
    assert zipnn.decompress_bytes(blob) == zipnn.decompress_bytes(
        blob, options=CodecOptions(backend="host"))


def test_auto_default_writes_the_reference_default_bytes(monkeypatch):
    assert zipnn.ZipNNConfig().plane_backend == "auto" == zipnn.DEFAULT.plane_backend
    a = _weights("bfloat16", (100, 90), 11)
    calls = []
    for module, name in ((device_entropy, "decode_planes"), (device_unplane, "consume_planes"),
                         (device_entropy, "encode_planes")):
        _spy(monkeypatch, module, name, calls)
    from repro_torch.core import device_plane
    _spy(monkeypatch, device_plane, "produce_planes_batched", calls)
    for cfg in ({}, CFG):
        ct = zipnn.compress_array(_tensor(a), zipnn.ZipNNConfig(**cfg))
        assert ct.blob == ref_zipnn.compress_array(a, ref_zipnn.ZipNNConfig(**cfg)).blob
        assert _bits(zipnn.decompress_array(ct, zipnn.ZipNNConfig(**cfg))) == a.tobytes()
    assert calls == []                         # CPU tensors, no card: the host path


@pytest.mark.parametrize(
    "requested,supported,leaf,device,card,expected",
    [
        ("auto", True, None, "cuda", True, "device"),      # host bytes, a card present
        ("auto", True, None, "cuda", False, "host"),       # host bytes, no card
        ("auto", True, None, "cpu", True, "host"),         # host bytes, device="cpu"
        ("auto", True, "cpu", "cuda", True, "host"),       # a CPU tensor stays on the host
        ("auto", False, None, "cuda", True, "host"),       # outside the envelope
        ("device", True, "cpu", "cpu", False, "device"),
        ("device", False, None, "cuda", True, "host"),
        ("host", True, None, "cuda", True, "host"),
        (None, True, None, "cuda", True, "host"),
    ],
)
def test_resolve_backend_rules(monkeypatch, requested, supported, leaf, device, card, expected):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    leaf = torch.zeros(3) if leaf == "cpu" else None
    assert resolve_backend(requested, supported, leaf, device) == expected


def test_resolve_backend_rejects_an_unknown_request():
    with pytest.raises(ValueError, match="unknown entropy backend"):
        resolve_backend("gpu", True, None, "cpu", "entropy")


def test_auto_sends_host_bytes_to_a_present_card(monkeypatch, tmp_path):
    """Under the "auto" default a byte stream and every file frame encode
    with K3 and K7 when ``device`` is a card that is present; a CPU tensor
    stays on the host.  The card is faked and the kernels' plain versions
    run, so only the routing is under test."""
    from repro_torch.core import device_plane

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    for module, name in ((device_plane, "produce_planes"), (device_entropy, "encode_planes")):
        def on_cpu(*a, _fn=getattr(module, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **dict(k, device="cpu"))

        monkeypatch.setattr(module, name, on_cpu)
    cfg = dict(chunk_param_bytes=1 << 15, backend="huffman")   # K3's 16 KiB chunks
    raw = _weights("bfloat16", 30_001, 12).tobytes() + b"\x05"
    blob = zipnn.compress_bytes(raw, "bfloat16", zipnn.ZipNNConfig(**cfg))
    assert calls == ["produce_planes", "encode_planes"]
    assert blob == ref_zipnn.compress_bytes(raw, "bfloat16", ref_zipnn.ZipNNConfig(**cfg))
    calls.clear()
    src, out = tmp_path / "w.raw", tmp_path / "w.znns"
    src.write_bytes(raw)
    zipnn.compress_file(str(src), str(out), "bfloat16", zipnn.ZipNNConfig(**cfg),
                        window_bytes=24_000)
    frames = len(list(engine.frame_records(str(out))))
    assert frames == 3
    assert calls == ["produce_planes", "encode_planes"] * frames
    calls.clear()
    a = _weights("bfloat16", (100, 90), 13)
    ct = zipnn.compress_array(_tensor(a), zipnn.ZipNNConfig(**cfg))
    assert calls == []
    assert ct.blob == ref_zipnn.compress_array(a, ref_zipnn.ZipNNConfig(**cfg)).blob


def _layout_array(dtype_name: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype_name == "bool":
        return rng.integers(0, 2, n).astype(bool)
    if dtype_name == "int8":
        return np.clip(rng.normal(0, 6, n), -128, 127).astype(np.int8)
    if dtype_name == "float64":
        return rng.standard_normal(n) * 0.02
    return (rng.standard_normal(n) * 0.5).astype(getattr(ml_dtypes, dtype_name))


@pytest.mark.parametrize("coder", ["huffman", "hufflib"])
@pytest.mark.parametrize(
    "dtype_name", ["float8_e4m3fn", "float8_e5m2", "int8", "bool", "float64"]
)
def test_other_layouts_byte_identical_to_reference(tmp_path, dtype_name, coder):
    cfg = dict(chunk_param_bytes=1 << 12, backend=coder)
    a = _layout_array(dtype_name, 12_345, seed=len(dtype_name))
    assert _util.dtype_name(_util.torch_dtype(dtype_name)) == a.dtype.name == dtype_name
    assert dtype_name in bitlayout.LAYOUTS
    want = ref_zipnn.compress_array(a, ref_zipnn.ZipNNConfig(**cfg))
    for threads in (0, 4):
        ct = zipnn.compress_array(
            _tensor(a), zipnn.ZipNNConfig(**cfg), options=CodecOptions(threads=threads)
        )
        assert ct.blob == want.blob and ct.dtype == want.dtype and ct.shape == want.shape
    back = zipnn.decompress_array(want, zipnn.ZipNNConfig(**cfg))
    assert back.dtype == _util.torch_dtype(dtype_name) and _bits(back) == a.tobytes()
    # a ZNS1 file of the same bytes, header dtype name included, with a tail
    raw = a.tobytes() + b"\x01"
    ref_out, port_out = io.BytesIO(), io.BytesIO()
    ref_engine.compress_file(io.BytesIO(raw), ref_out, dtype_name, ref_zipnn.ZipNNConfig(**cfg),
                             window_bytes=4096)
    engine.compress_file(io.BytesIO(raw), port_out, dtype_name, zipnn.ZipNNConfig(**cfg),
                         window_bytes=4096, device="cpu")
    assert port_out.getvalue() == ref_out.getvalue()


def test_dtype_names_match_the_reference_for_every_layout():
    """Blob and ZNS1 header dtype names come from ``_util.dtype_name``:
    for every layout torch has a dtype for, the name round-trips and
    equals numpy's / ml_dtypes' name, which the reference writes."""
    missing = []
    for name in bitlayout.LAYOUTS:
        if not isinstance(getattr(torch, name, None), torch.dtype):
            missing.append(name)
            continue
        ref = np.dtype(getattr(ml_dtypes, name, name)).name
        assert _util.dtype_name(_util.torch_dtype(name)) == name == ref
    assert missing == ["float8_e4m3"]             # no torch dtype: bytes API only
