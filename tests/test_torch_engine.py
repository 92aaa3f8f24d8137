"""The port's ZNS1 file engine against the reference's, byte for byte.

A ZNS1 file is a header and a run of frames, each one ZNN1 blob of one
window.  Contract under test, with exact equality as the tolerance: for
the same raw stream, config and window, ``repro_torch.core.engine``
writes the reference's file for bf16, fp16 and fp32 with an unaligned
tail, for every ``threads`` and ``pipeline_depth``, and on the device
backend (``device="cpu"`` runs the kernels' plain versions); each package
decodes the other's files; the frozen ``tests/fixtures/bf16_stream.znns``
decodes; and the reference's failure cases (empty, truncated, a missing
middle frame, a bad frame CRC, an interrupted write, a failed pipelined
frame, mixing ``read`` and ``frames``) behave as in the reference.
"""

import io
import json
import os
import struct

import ml_dtypes
import numpy as np
import pytest

from repro.core import engine as ref_engine
from repro.core import zipnn as ref_zipnn
from repro.core.options import CodecOptions as RefOptions
from repro_torch.core import device_entropy, device_unplane, engine, zipnn
from repro_torch.core.options import CodecOptions

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NP_DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16, "float32": np.float32}
CFG = dict(chunk_param_bytes=1 << 12, backend="huffman")
WINDOW = 1 << 14                      # several frames per stream


def _stream(dtype_name: str, n: int = 20_000, seed: int = 0) -> bytes:
    """Weights of ``dtype_name`` plus one stray byte: the last frame's TAIL."""
    rng = np.random.default_rng(seed + len(dtype_name))
    scale = 0.3 if dtype_name == "float32" else 0.02
    w = (rng.standard_normal(n) * scale).astype(NP_DTYPES[dtype_name])
    return w.tobytes() + b"\x2a"


def _ref_file(tmp_path, raw: bytes, dtype_name: str) -> bytes:
    src, dst = tmp_path / "ref.raw", tmp_path / "ref.znns"
    src.write_bytes(raw)
    ref_engine.compress_file(
        str(src), str(dst), dtype_name, ref_zipnn.ZipNNConfig(**CFG), window_bytes=WINDOW,
        options=RefOptions(threads=0),
    )
    return dst.read_bytes()


def _port_file(tmp_path, raw: bytes, dtype_name: str, **kw) -> bytes:
    src, dst = tmp_path / "port.raw", tmp_path / "port.znns"
    src.write_bytes(raw)
    raw_b, comp_b = engine.compress_file(
        str(src), str(dst), dtype_name, zipnn.ZipNNConfig(**CFG), window_bytes=WINDOW,
        device="cpu", **kw,
    )
    assert raw_b == len(raw) and comp_b == dst.stat().st_size
    return dst.read_bytes()


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("threads", [0, 4])
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16", "float32"])
def test_files_byte_identical_to_reference(tmp_path, dtype_name, threads, depth):
    raw = _stream(dtype_name)
    want = _ref_file(tmp_path, raw, dtype_name)
    got = _port_file(
        tmp_path, raw, dtype_name, options=CodecOptions(threads=threads), pipeline_depth=depth
    )
    assert got == want
    assert len(list(engine.frame_records(io.BytesIO(got)))) > 2


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16", "float32"])
def test_each_package_decodes_the_others_files(tmp_path, dtype_name):
    raw = _stream(dtype_name, seed=1)
    ref_file = _ref_file(tmp_path, raw, dtype_name)
    port_file = _port_file(tmp_path, raw, dtype_name)
    out = io.BytesIO()
    n = engine.decompress_file(
        io.BytesIO(ref_file), out, zipnn.ZipNNConfig(**CFG),
        options=CodecOptions(threads=4), pipeline_depth=3, device="cpu",
    )
    assert n == len(raw) and out.getvalue() == raw
    out = io.BytesIO()
    assert ref_engine.decompress_file(io.BytesIO(port_file), out) == len(raw)
    assert out.getvalue() == raw
    assert [r[:2] for r in engine.frame_records(io.BytesIO(port_file))] == [
        r[:2] for r in ref_engine.frame_records(io.BytesIO(ref_file))
    ]


@pytest.mark.parametrize("entropy_backend", [None, "host"])
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16", "float32"])
def test_device_backend_writes_the_same_file_and_decodes_through_the_kernels(
    tmp_path, monkeypatch, dtype_name, entropy_backend
):
    raw = _stream(dtype_name, seed=2)
    opts = CodecOptions(threads=4, backend="device", entropy_backend=entropy_backend)
    got = _port_file(tmp_path, raw, dtype_name, options=opts)
    assert got == _ref_file(tmp_path, raw, dtype_name)
    calls = {"k1": 0, "k2": 0}
    decode, consume = device_entropy.decode_planes, device_unplane.consume_planes
    monkeypatch.setattr(device_entropy, "decode_planes",
                        lambda *a, **k: calls.__setitem__("k1", calls["k1"] + 1) or decode(*a, **k))
    monkeypatch.setattr(device_unplane, "consume_planes",
                        lambda *a, **k: calls.__setitem__("k2", calls["k2"] + 1) or consume(*a, **k))
    with engine.DecompressReader(io.BytesIO(got), zipnn.ZipNNConfig(**CFG), options=opts,
                                 device="cpu") as r:
        assert r.read() == raw
    frames = len(list(engine.frame_records(io.BytesIO(got))))
    assert calls["k2"] == frames
    assert calls["k1"] == (frames if entropy_backend is None else 0)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_frozen_stream_fixture_decodes(backend):
    with open(os.path.join(FIXTURES, "meta.json")) as f:
        fx = next(x for x in json.load(f)["fixtures"] if x["kind"] == "stream")
    with open(os.path.join(FIXTURES, fx["raw"]), "rb") as f:
        raw = f.read()
    cfg = zipnn.ZipNNConfig(**fx["config"])
    out = io.BytesIO()
    n = engine.decompress_file(
        os.path.join(FIXTURES, fx["blob"]), out, cfg,
        options=CodecOptions(backend=backend), device="cpu",
    )
    assert n == len(raw) and out.getvalue() == raw
    with engine.DecompressReader(os.path.join(FIXTURES, fx["blob"]), cfg, device="cpu") as r:
        assert r.dtype_name == fx["dtype"] and r.window == fx["window_bytes"]


# ---------------------------------------------------------------------------
# failure cases, each against the reference's behaviour
# ---------------------------------------------------------------------------

def _both(fn):
    """Run ``fn(mod)`` with the reference's engine and the port's; return
    both results (or the exception types they raised)."""
    out = []
    for mod in (ref_engine, engine):
        try:
            out.append(fn(mod))
        except Exception as e:            # the types are compared below
            out.append(type(e))
    return out


def _writer(mod, sink, **kw):
    if mod is engine:
        return engine.CompressWriter(sink, "bfloat16", window_bytes=1 << 17, device="cpu", **kw)
    return ref_engine.CompressWriter(sink, "bfloat16", window_bytes=1 << 17, **kw)


def _reader(mod, src):
    return engine.DecompressReader(src, device="cpu") if mod is engine else ref_engine.DecompressReader(src)


def _written(mod, data: bytes) -> bytes:
    sink = io.BytesIO()
    with _writer(mod, sink) as w:
        w.write(data)
    return sink.getvalue()


def test_empty_stream_round_trips(tmp_path):
    def run(mod):
        blob = _written(mod, b"")
        return blob, _reader(mod, io.BytesIO(blob)).read()

    ref, port = _both(run)
    assert port == ref and port[1] == b""


def test_truncated_stream_raises():
    data = _stream("bfloat16", 100_000)

    def run(mod):
        whole = _written(mod, data)
        return _reader(mod, io.BytesIO(whole[: len(whole) - 40])).read()

    assert _both(run) == [OSError, OSError]


def test_missing_middle_frame_detected():
    data = _stream("bfloat16", 250_000, seed=9)

    def run(mod):
        blob = _written(mod, data)
        frame, off, spans = struct.Struct("<BQQI"), 32, []
        while True:
            kind, _rl, cl, _crc = frame.unpack_from(blob, off)
            spans.append((off, frame.size + cl))
            off += frame.size + cl
            if kind == 0:
                break
        assert len(spans) > 2
        start, length = spans[1]
        with pytest.raises(IOError, match="end frame declares"):
            _reader(mod, io.BytesIO(blob[:start] + blob[start + length :])).read()
        return len(spans)

    ref, port = _both(run)
    assert port == ref


def test_corrupt_frame_crc_raises():
    data = _stream("bfloat16", 100_000, seed=6)

    def run(mod):
        blob = bytearray(_written(mod, data))
        blob[len(blob) // 2] ^= 0xFF
        with pytest.raises(IOError, match="CRC"):
            _reader(mod, io.BytesIO(bytes(blob))).read()
        return bytes(blob)

    ref, port = _both(run)
    assert port == ref


def test_interrupted_write_never_looks_complete():
    data = _stream("bfloat16", 200_000, seed=7)

    def run(mod):
        sink = io.BytesIO()
        with pytest.raises(RuntimeError):
            with _writer(mod, sink) as w:
                w.write(data)
                raise RuntimeError("interrupted mid-stream")
        with pytest.raises(IOError):
            _reader(mod, io.BytesIO(sink.getvalue())).read()
        return sink.getvalue()

    ref, port = _both(run)
    assert port == ref


def test_mixed_read_then_frames_loses_nothing():
    data = _stream("bfloat16", 250_000, seed=8)

    def run(mod):
        r = _reader(mod, io.BytesIO(_written(mod, data)))
        head = r.read(16)
        return head + b"".join(r.frames())

    assert _both(run) == [data, data]


def test_failed_pipelined_frame_aborts_the_stream(monkeypatch):
    """A frame that fails on a pipeline thread surfaces at close, and the
    file has no end frame."""
    data = _stream("bfloat16", 300_000, seed=3)
    compress = zipnn.compress_bytes
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("frame failed")
        return compress(*a, **k)

    monkeypatch.setattr(zipnn, "compress_bytes", flaky)
    sink = io.BytesIO()
    with pytest.raises(RuntimeError, match="frame failed"):
        with _writer(engine, sink, options=CodecOptions(threads=4), pipeline_depth=3) as w:
            w.write(data)
    assert len(calls) >= 2
    with pytest.raises(IOError, match="missing end frame"):
        engine.DecompressReader(io.BytesIO(sink.getvalue()), device="cpu").read()


def test_incremental_writes_and_odd_reads():
    data = _stream("bfloat16", 150_000, seed=4)
    sink = io.BytesIO()
    with zipnn.CompressWriter(sink, "bfloat16", window_bytes=1 << 17, device="cpu") as w:
        for i in range(0, len(data), 9973):
            w.write(data[i : i + 9973])
    assert w.raw_bytes == len(data) and w.comp_bytes == len(sink.getvalue())
    assert sink.getvalue() == _written(ref_engine, data)
    r = zipnn.DecompressReader(io.BytesIO(sink.getvalue()), device="cpu")
    out = bytearray()
    while True:
        piece = r.read(31337)
        if not piece:
            break
        out += piece
    assert bytes(out) == data


class _Recording(io.BytesIO):
    """A file that records every size it is asked to read."""

    def __init__(self, data: bytes):
        super().__init__(data)
        self.asked = []

    def read(self, n=-1):
        self.asked.append(n)
        return super().read(n)


def test_a_corrupt_comp_len_reads_in_bounded_pieces():
    """A flipped u64 length field fails on the first short read, having
    asked for at most 8 MiB at a time."""
    blob = bytearray(_written(engine, _stream("bfloat16", 20_000)))
    struct.pack_into("<Q", blob, 32 + 9, 1 << 60)      # first frame's comp_len
    for read in (lambda fp: engine.DecompressReader(fp, device="cpu").read(),
                 lambda fp: list(engine.frame_records(fp))):
        fp = _Recording(bytes(blob))
        with pytest.raises(IOError, match="truncated ZNS1 frame body"):
            read(fp)
        assert max(fp.asked) <= 8 << 20
