"""The port's delta streams (§4.2) against the reference's, byte for byte.

A delta stream is the XOR of a tensor with a base, byte-grouped and coded
with the §4.2 per-chunk Huffman-or-LZ choice.  On the device plane path
the XOR is fused into K3; decode runs K1, then K2 with the base.  On the
CPU the kernels' wrappers run their plain versions (``device="cpu"``).
Contract under test, with exact equality as the tolerance:
``delta_compress`` / ``delta_compress_batched`` blobs on the device
backend equal the port's host blobs and the reference's
``backend="device"`` blobs for bf16, fp16 and fp32; ``delta_decompress``
restores the new tensor bit for bit on the host and device paths; the
frozen ``tests/fixtures/bf16_delta`` blob decodes; a device backend with
``device="cuda"`` and no card raises.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import zipnn as ref_zipnn
from repro.core.options import CodecOptions as RefOptions
from repro_torch import _util
from repro_torch.core import device_plane, device_unplane, zipnn
from repro_torch.core.options import CodecOptions

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NP_DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16, "float32": np.float32}
INTS = {2: np.int16, 4: np.int32}
CHUNK_PARAMS = {"bfloat16": 32768, "float16": 32768, "float32": 65536}
DEVICE = CodecOptions(backend="device")


def _pair(dtype_name: str, n: int, seed: int, lr: float = 1e-3):
    """A base and the same weights after one small update step."""
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal(n) * 0.02).astype(np.float32)
    new = base + lr * rng.standard_normal(n).astype(np.float32)
    return base.astype(NP_DTYPES[dtype_name]), new.astype(NP_DTYPES[dtype_name])


def _tensor(a: np.ndarray) -> torch.Tensor:
    ints = INTS[a.dtype.itemsize]
    return torch.from_numpy(a.view(ints).copy()).view(_util.torch_dtype(a.dtype.name))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


def _cfg(dtype_name: str, coder: str = "huffman"):
    return dict(chunk_param_bytes=CHUNK_PARAMS[dtype_name], backend=coder)


@pytest.mark.parametrize("coder", ["huffman", "hufflib"])
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16", "float32"])
def test_delta_blobs_match_host_and_reference(dtype_name, coder):
    base, new = _pair(dtype_name, 40_003, seed=len(dtype_name) + len(coder))
    want = ref_zipnn.delta_compress(
        new, base, ref_zipnn.ZipNNConfig(**_cfg(dtype_name, coder)),
        options=RefOptions(backend="device"),
    ).blob
    cfg = zipnn.ZipNNConfig(**_cfg(dtype_name, coder))
    tn, tb = _tensor(new), _tensor(base)
    host = zipnn.delta_compress(tn, tb, cfg)
    dev = zipnn.delta_compress(tn, tb, cfg, options=DEVICE, device="cpu")
    assert host.blob == want and dev.blob == want
    assert dev.dtype == dtype_name and dev.shape == (40_003,)
    np.testing.assert_array_equal(_bits(zipnn.delta_decompress(dev, tb, cfg)), _bits(tn))


def test_delta_batched_matches_serial_and_reference(monkeypatch):
    pairs = [_pair("bfloat16", n, seed=n) for n in (16384, 20_000, 100)]
    pairs.append(_pair("float32", 30_000, seed=7))
    pairs.append(_pair("float16", 17_000, seed=8))
    cfg = dict(chunk_param_bytes=32768, backend="huffman")
    want = ref_zipnn.delta_compress_batched(
        [n for _, n in pairs], [b for b, _ in pairs], ref_zipnn.ZipNNConfig(**cfg),
        options=RefOptions(backend="device"),
    )
    news = [_tensor(n) for _, n in pairs]
    bases = [_tensor(b) for b, _ in pairs]
    launches = []
    produce = device_plane.produce_planes_batched
    monkeypatch.setattr(
        device_plane, "produce_planes_batched",
        lambda bufs, *a, **k: launches.append(len(bufs)) or produce(bufs, *a, **k),
    )
    got = zipnn.delta_compress_batched(
        news, bases, zipnn.ZipNNConfig(**cfg), options=DEVICE, device="cpu"
    )
    assert [c.blob for c in got] == [c.blob for c in want]
    serial = [zipnn.delta_compress(n, b, zipnn.ZipNNConfig(**cfg)) for n, b in zip(news, bases)]
    assert [c.blob for c in got] == [c.blob for c in serial]
    # one K3 batch per dtype in the envelope: three bf16 pairs, one fp16;
    # fp32 at 8192-byte plane chunks takes the host path
    assert sorted(launches) == [1, 3]


def test_delta_batched_rejects_a_mismatched_pair():
    base, new = _pair("bfloat16", 1000, seed=1)
    with pytest.raises(ValueError, match="matching shape/dtype"):
        zipnn.delta_compress_batched(
            [_tensor(new)], [_tensor(base[:999])], options=DEVICE, device="cpu"
        )
    with pytest.raises(ValueError, match="pair 1:1"):
        zipnn.delta_compress_batched([_tensor(new)], [], options=DEVICE, device="cpu")


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(device_resident=True), dict(options=DEVICE), dict(options=CodecOptions(backend="auto"))],
    ids=["host", "resident", "device", "auto"],
)
def test_delta_decompress_paths_restore_bits(monkeypatch, kw):
    base, new = _pair("bfloat16", 50_000, seed=3)
    cfg = zipnn.ZipNNConfig(**_cfg("bfloat16"))
    ct = zipnn.delta_compress(_tensor(new), _tensor(base), cfg, options=DEVICE, device="cpu")
    calls = []
    consume = device_unplane.consume_payloads
    monkeypatch.setattr(
        device_unplane, "consume_payloads",
        lambda *a, **k: calls.append(k.get("base") is not None) or consume(*a, **k),
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = zipnn.delta_decompress(ct, _tensor(base), cfg, device="cpu", **kw)
    assert out.device.type == "cpu" and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(out), _bits(_tensor(new)))
    # the device path (K1, then K2 with the base) runs when asked for;
    # "auto" with no card and a CPU base stays on the host
    assert calls == ([] if kw in (dict(), dict(options=CodecOptions(backend="auto"))) else [True])


def _fixture(name):
    with open(os.path.join(FIXTURES, "meta.json")) as f:
        return next(fx for fx in json.load(f)["fixtures"] if fx["name"] == name)


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("resident", [False, True])
def test_golden_bf16_delta_fixture_decodes(resident):
    fx = _fixture("bf16_delta")
    shape = tuple(fx["shape"])
    base = torch.frombuffer(bytearray(_read(fx["base"])), dtype=torch.bfloat16).reshape(shape)
    ct = zipnn.CompressedTensor(_read(fx["blob"]), fx["dtype"], shape)
    out = zipnn.delta_decompress(
        ct, base, zipnn.ZipNNConfig(**fx["config"]), device_resident=resident, device="cpu"
    )
    assert out.view(torch.uint8).numpy().tobytes() == _read(fx["raw"])
    # and the port re-encodes it to the frozen blob on both plane backends
    new = torch.frombuffer(bytearray(_read(fx["raw"])), dtype=torch.bfloat16).reshape(shape)
    for opts in (None, DEVICE):
        again = zipnn.delta_compress(
            new, base, zipnn.ZipNNConfig(**fx["config"]), options=opts, device="cpu"
        )
        assert again.blob == ct.blob


def test_delta_shape_mismatch_raises():
    base, new = _pair("bfloat16", 1000, seed=2)
    ct = zipnn.delta_compress(_tensor(new), _tensor(base))
    with pytest.raises(ValueError, match="matching shape/dtype"):
        zipnn.delta_decompress(ct, _tensor(base[:999]))
    with pytest.raises(ValueError, match="matching shape/dtype"):
        zipnn.delta_compress(_tensor(new), _tensor(base).to(torch.float16))


def test_delta_device_backend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base, new = _pair("bfloat16", 20_000, seed=4)
    cfg = zipnn.ZipNNConfig(**_cfg("bfloat16"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zipnn.delta_compress(_tensor(new), _tensor(base), cfg, options=DEVICE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zipnn.delta_compress_batched([_tensor(new)], [_tensor(base)], cfg, options=DEVICE)
    ct = zipnn.delta_compress(_tensor(new), _tensor(base), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zipnn.delta_decompress(ct, _tensor(base), cfg, device_resident=True)
