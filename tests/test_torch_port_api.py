"""The port's API surface against the reference's documented one
(``docs/INVARIANTS.md``): the launch-window cap ``ZIPNN_MAX_BATCH_BYTES``,
the legacy per-call codec kwargs, and the package re-exports.

Contract under test, with exact equality as the tolerance:
``device_plane._batch_bytes_from_env`` parses the variable as the
reference does (a positive int, ``0x`` allowed, ``ValueError`` naming the
variable otherwise), the port reads it once at import and a cap moves no
byte; ``resolve_options`` and every entry point that takes ``options=``
take ``threads=`` / ``backend=`` / ``entropy_backend=`` (and
``device_resident=`` where the reference has it) with the reference's
precedence (explicit kwarg > options field > config) and one
``DeprecationWarning`` for the three codec knobs, giving the same bytes as
the ``options=`` spelling; every name of ``repro.core.__all__`` and
``repro.kernels.__all__`` is in the port's package or on its named list of
unported names.
"""

import contextlib
import dataclasses
import inspect
import io
import json
import os
import subprocess
import sys
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.kernels as ref_kernels
from repro.core import zipnn as ref_zipnn
from repro.kernels import ops as ref_ops
import repro_torch.core as port_core
import repro_torch.kernels as port_kernels
from repro_torch import _util
from repro_torch.checkpoint import hub
from repro_torch.core import (
    bitlayout, codec, container, device_entropy, device_plane, device_unplane, engine, huffman,
    zipnn,
)
from repro_torch.core.options import DEFAULT_OPTIONS, CodecOptions, resolve_options
from repro_torch.serve import CompressedParamStore

CFG = dict(chunk_param_bytes=1 << 12, backend="huffman")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _weights(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.02).astype(ml_dtypes.bfloat16)


def _tensor(a: np.ndarray) -> torch.Tensor:
    u8 = torch.from_numpy(np.ascontiguousarray(a).reshape(-1).view(np.uint8).copy())
    return u8.view(_util.torch_dtype(a.dtype.name)).reshape(a.shape)


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@contextlib.contextmanager
def _deprecations(n: int):
    """Exactly ``n`` DeprecationWarnings inside the block."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        yield
    got = [w for w in seen if issubclass(w.category, DeprecationWarning)]
    assert len(got) == n, [str(w.message) for w in got]


# ---------------------------------------------------------------------------
# ZIPNN_MAX_BATCH_BYTES
# ---------------------------------------------------------------------------

# the reference's parse cases (tests/test_payload_feed.py, TestBatchBytesEnv):
# None unsets the variable; a ValueError entry must raise
BATCH_ENV_CASES = [
    (None, device_plane.DEFAULT_BATCH_BYTES),
    ("123456", 123456),
    ("0x100000", 1 << 20),
    ("1", 1),
    ("abc", ValueError),
    ("", ValueError),
    ("1.5", ValueError),
    ("0", ValueError),
    ("-4096", ValueError),
]


@pytest.mark.parametrize("raw,want", BATCH_ENV_CASES)
def test_batch_bytes_env_parses_as_the_reference(monkeypatch, raw, want):
    from repro.core import device_plane as ref_device_plane

    if raw is None:
        monkeypatch.delenv("ZIPNN_MAX_BATCH_BYTES", raising=False)
    else:
        monkeypatch.setenv("ZIPNN_MAX_BATCH_BYTES", raw)
    if want is ValueError:
        for fn in (device_plane._batch_bytes_from_env, ref_device_plane._batch_bytes_from_env):
            with pytest.raises(ValueError, match="ZIPNN_MAX_BATCH_BYTES"):
                fn()
    else:
        assert device_plane._batch_bytes_from_env() == want
        assert ref_device_plane._batch_bytes_from_env() == want
    assert device_plane.DEFAULT_BATCH_BYTES == ref_device_plane.DEFAULT_BATCH_BYTES == 256 << 20
    assert device_entropy.MAX_BATCH_BYTES is device_plane.MAX_BATCH_BYTES


# Run in a fresh interpreter, so that no test worker's module state changes:
# the cap it read, and the hashes of a pytree's blobs encoded and decoded on
# the device route (K3 windows and K2 windows split at the cap; on the CPU
# their plain versions).
_CAP_PROBE = r"""
import hashlib, json, sys
import numpy as np, torch
from repro_torch.core import device_entropy, device_plane, zipnn
from repro_torch.core.options import CodecOptions
rng = np.random.default_rng(0)
tree = {f"w{i}": torch.from_numpy((rng.standard_normal((300, 1000)) * 0.02).astype(np.float32))
        .to(torch.bfloat16) for i in range(3)}
cfg = zipnn.ZipNNConfig(chunk_param_bytes=1 << 14, backend="huffman")
opts = CodecOptions(backend="device")
m = zipnn.compress_pytree(tree, cfg, options=opts, device="cpu")
back = zipnn.decompress_pytree(m, cfg, options=opts, device="cpu")
assert all(torch.equal(back[k].view(torch.int16), t.view(torch.int16)) for k, t in tree.items())
print(json.dumps({
    "cap": device_plane.MAX_BATCH_BYTES,
    "shared": device_entropy.MAX_BATCH_BYTES is device_plane.MAX_BATCH_BYTES,
    "blobs": hashlib.sha256(b"".join(ct.blob for ct in m["leaves"])).hexdigest(),
}))
"""


def _probe(cap):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("ZIPNN_MAX_BATCH_BYTES", None)
    if cap is not None:
        env["ZIPNN_MAX_BATCH_BYTES"] = cap
    return subprocess.run([sys.executable, "-c", _CAP_PROBE], env=env, capture_output=True,
                          text=True, timeout=300)


def test_batch_bytes_env_is_read_at_import_and_moves_no_byte():
    small, default = _probe("1048576"), _probe(None)
    assert small.returncode == 0 and default.returncode == 0, small.stderr + default.stderr
    a, b = json.loads(small.stdout), json.loads(default.stdout)
    assert a["cap"] == 1_048_576 and b["cap"] == 256 << 20
    assert a["shared"] and b["shared"]
    assert a["blobs"] == b["blobs"]                # 1.8 MB of leaves: several windows at 1 MiB
    bad = _probe("0")
    assert bad.returncode != 0 and "ZIPNN_MAX_BATCH_BYTES" in bad.stderr


# ---------------------------------------------------------------------------
# the legacy codec kwargs
# ---------------------------------------------------------------------------

def test_resolve_precedence_kwarg_over_field_over_config():
    opts = CodecOptions(threads=4, backend="device", entropy_backend="device")
    with _deprecations(1):
        merged = resolve_options(opts, threads=1, backend="host")
    assert merged.threads == 1 and merged.backend == "host"   # explicit kwargs win
    assert merged.entropy_backend == "device"                 # an untouched field survives
    with _deprecations(0):
        assert resolve_options(CodecOptions(threads=2)).threads == 2
        assert resolve_options(None).threads is None          # None defers to the config


def test_resolve_options_passes_through_without_a_warning():
    opts = CodecOptions(threads=2)
    with _deprecations(0):
        assert resolve_options(opts) is opts
        assert resolve_options(None) is DEFAULT_OPTIONS


@pytest.mark.parametrize("kw", [{"threads": 2}, {"backend": "host"},
                                {"entropy_backend": "host"},
                                {"threads": 0, "backend": "host", "entropy_backend": "host"}])
def test_each_legacy_codec_kwarg_warns_once(kw):
    with _deprecations(1):
        merged = resolve_options(None, **kw)
    assert all(getattr(merged, k) == v for k, v in kw.items())


def test_device_resident_kwarg_does_not_warn():
    with _deprecations(0):
        merged = resolve_options(CodecOptions(), device_resident=True)
    assert merged.device_resident is True
    with _deprecations(0):
        assert resolve_options(CodecOptions(device_resident=True),
                               device_resident=False).device_resident is False


def test_compress_bytes_threads_kwarg_gives_the_reference_blob():
    raw = b"\x01\x02" * 8
    with _deprecations(1):
        legacy = zipnn.compress_bytes(raw, "bfloat16", threads=0)
    with _deprecations(0):
        bagged = zipnn.compress_bytes(raw, "bfloat16", options=CodecOptions(threads=0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_zipnn.compress_bytes(raw, "bfloat16", threads=0)
    assert legacy == bagged == want


_LEAF = _weights((64, 96), 1)
_BASE = _weights((64, 96), 2)


def _surfaces(tmp_path):
    """(name, call(**knobs)) for every entry point that takes options=;
    each call returns bytes (or numbers) to compare across spellings."""
    cfg = zipnn.ZipNNConfig(**CFG)
    raw = _LEAF.tobytes()
    t, b = _tensor(_LEAF), _tensor(_BASE)
    ct = zipnn.compress_array(t, cfg)
    dct = zipnn.delta_compress(t, b, cfg)
    man = zipnn.compress_pytree({"a": t, "b": b}, cfg)
    src = tmp_path / "raw.bin"
    src.write_bytes(raw)
    zfile = tmp_path / "ref.znns"
    engine.compress_file(str(src), str(zfile), "bfloat16", cfg, options=CodecOptions(),
                         device="cpu")

    def writer(**kw):
        buf = io.BytesIO()
        with engine.CompressWriter(buf, "bfloat16", cfg, device="cpu", **kw) as w:
            w.write(raw)
        return buf.getvalue()

    def reader(**kw):
        with engine.DecompressReader(io.BytesIO(zfile.read_bytes()), cfg, device="cpu",
                                     **kw) as r:
            return r.read()

    def comp_file(**kw):
        out = io.BytesIO()
        engine.compress_file(str(src), out, "bfloat16", cfg, device="cpu", **kw)
        return out.getvalue()

    def decomp_file(**kw):
        out = io.BytesIO()
        engine.decompress_file(str(zfile), out, cfg, device="cpu", **kw)
        return out.getvalue()

    def store(**kw):
        s = CompressedParamStore.from_params({"layers": {"w": torch.stack([t, b])}}, cfg,
                                             device="cpu", **kw)
        return b"".join(c.blob for c in s.manifest("layers", 0)["leaves"])

    def store_init(**kw):
        return dataclasses.astuple(CompressedParamStore(cfg, device="cpu", **kw)._options)

    return [
        ("compress_bytes", lambda **kw: zipnn.compress_bytes(raw, "bfloat16", cfg,
                                                             device="cpu", **kw)),
        ("decompress_bytes", lambda **kw: zipnn.decompress_bytes(ct.blob, cfg, device="cpu",
                                                                 **kw)),
        ("compress_array", lambda **kw: zipnn.compress_array(t, cfg, device="cpu", **kw).blob),
        ("decompress_array", lambda **kw: _bits(zipnn.decompress_array(ct, cfg, device="cpu",
                                                                       **kw))),
        ("compress_pytree", lambda **kw: b"".join(
            c.blob for c in zipnn.compress_pytree({"a": t, "b": b}, cfg, device="cpu",
                                                  **kw)["leaves"])),
        ("decompress_pytree", lambda **kw: b"".join(
            _bits(x) for x in zipnn.decompress_pytree(man, cfg, device="cpu", **kw).values())),
        ("delta_compress", lambda **kw: zipnn.delta_compress(t, b, cfg, device="cpu",
                                                             **kw).blob),
        ("delta_compress_batched", lambda **kw: b"".join(
            c.blob for c in zipnn.delta_compress_batched([t], [b], cfg, device="cpu", **kw))),
        ("delta_decompress", lambda **kw: _bits(zipnn.delta_decompress(dct, b, cfg,
                                                                       device="cpu", **kw))),
        ("CompressWriter", writer),
        ("DecompressReader", reader),
        ("compress_file", comp_file),
        ("decompress_file", decomp_file),
        ("simulate_transfer", lambda **kw: hub.simulate_transfer(
            raw, "bfloat16", "cached_download_cloud", config=cfg, device="cpu", **kw).comp_bytes),
        ("simulate_file_transfer", lambda **kw: hub.simulate_file_transfer(
            str(src), "bfloat16", "cached_download_cloud", config=cfg, device="cpu",
            **kw).comp_bytes),
        ("CompressedParamStore.from_params", store),
        ("CompressedParamStore", store_init),
    ]


SURFACES = [
    "compress_bytes", "decompress_bytes", "compress_array", "decompress_array",
    "compress_pytree", "decompress_pytree", "delta_compress", "delta_compress_batched",
    "delta_decompress", "CompressWriter", "DecompressReader", "compress_file",
    "decompress_file", "simulate_transfer", "simulate_file_transfer",
    "CompressedParamStore.from_params", "CompressedParamStore",
]


@pytest.mark.parametrize("name", SURFACES)
def test_every_surface_takes_the_legacy_kwargs(tmp_path, name):
    call = dict(_surfaces(tmp_path))[name]
    legacy = {"threads": 4, "backend": "device", "entropy_backend": "host"}
    with _deprecations(0):
        bagged = call(options=CodecOptions(**legacy))
    with _deprecations(1):
        got = call(**legacy)
    assert got == bagged
    # an explicit kwarg overrides the options field, with the same bytes
    with _deprecations(1):
        over = call(options=CodecOptions(threads=0, backend="host"), **legacy)
    assert over == bagged


def test_device_resident_kwarg_on_the_decode_stages():
    cfg = zipnn.ZipNNConfig(**CFG)
    ct = zipnn.compress_array(_tensor(_LEAF), cfg)
    meta, mv = container.unpack_stream(ct.blob)
    payloads = [[container.payload_view(meta, mv, p, c) for c in range(len(meta.entries[p]))]
                for p in range(meta.n_planes)]
    params = codec.CodecParams(chunk_bytes=meta.chunk_bytes, backend="huffman")
    layout = bitlayout.layout_for("bfloat16")
    want = _LEAF.tobytes()
    for resident in (False, True):
        with _deprecations(0):
            planes = device_entropy.decode_planes(meta.entries, payloads, meta.tables, params,
                                                  device="cpu", device_resident=resident)
            one = device_unplane.consume_planes(planes, layout, device_resident=resident)
            many = device_unplane.consume_planes_batched([planes, planes], layout,
                                                         device_resident=resident)
            pay = device_unplane.consume_payloads(meta.entries, payloads, meta.tables, params,
                                                  layout, device="cpu",
                                                  device_resident=resident)
        for elems in (one, pay, *many):
            assert elems.device.type == "cpu" and _bits(elems) == want
    for fn in (device_entropy.decode_planes, device_unplane.consume_planes,
               device_unplane.consume_planes_batched, device_unplane.consume_payloads):
        assert inspect.signature(fn).parameters["device_resident"].default is False


# ---------------------------------------------------------------------------
# re-exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref,port", [(ref_core, port_core), (ref_kernels, port_kernels)],
                         ids=["core", "kernels"])
def test_every_reference_name_is_exported_or_listed_unported(ref, port):
    missing = [n for n in ref.__all__ if not hasattr(port, n) and n not in port.UNPORTED]
    assert missing == []
    assert all(n in ref.__all__ and not hasattr(port, n) for n in port.UNPORTED)
    assert all(n in port.__all__ for n in ref.__all__ if n not in port.UNPORTED)


def test_core_reexports_are_the_codec_api():
    from repro_torch.core import compress_array, get_pool, LAYOUTS, Method

    assert compress_array is zipnn.compress_array
    assert get_pool is engine.get_pool
    assert LAYOUTS is bitlayout.LAYOUTS and Method is codec.Method
    assert port_core.UNPORTED == ()
    assert port_core.exponent_histogram is port_core.stats.exponent_histogram
    assert port_core.baselines.BASELINES.keys() == ref_core.baselines.BASELINES.keys()


def test_kernels_export_ops_and_the_reference_huffman_encode_chunks():
    assert port_kernels.ops.__name__ == "repro_torch.kernels.ops"
    ref_sig = inspect.signature(ref_ops.huffman_encode_chunks).parameters
    port_sig = inspect.signature(port_kernels.huffman_encode_chunks).parameters
    assert list(port_sig)[: len(ref_sig)] == list(ref_sig)
    assert all(port_sig[k].default == ref_sig[k].default for k in ref_sig)
    rng = np.random.default_rng(3)
    syms = rng.choice(8, p=[0.4, 0.2, 0.1, 0.1, 0.1, 0.05, 0.03, 0.02], size=20_000) \
        .astype(np.uint8)
    lens = huffman.code_lengths(np.bincount(syms, minlength=256) + 1)
    codes = huffman.canonical_codes(lens)
    got = port_kernels.huffman_encode_chunks(syms, lens, codes, device="cpu")
    assert got == ref_kernels.huffman_encode_chunks(syms, lens, codes)
