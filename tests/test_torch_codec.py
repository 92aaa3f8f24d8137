"""The port's host codec against the reference's: same bytes, same fixtures.

``repro_torch.core`` keeps its own copy of the host format layer.  The
contract under test: for the same raw bytes and config the port emits the
reference's ZNN1 blob byte for byte (bf16, fp16 and fp32, both coders,
any thread count), decodes every frozen ``tests/fixtures/*.znn`` bit
exactly, and re-encodes the canonical-coder fixtures to the frozen blobs.
Plus the package rule that keeps the port independent: no file of
``src/repro_torch`` (nor ``chip_smoke.py``) imports jax, ml_dtypes or the
reference package.
"""

import ast
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import zipnn as ref_zipnn
from repro_torch import _util
from repro_torch.core import zipnn
from repro_torch.core.options import CodecOptions

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
ROOT = os.path.dirname(HERE)

NP_DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16, "float32": np.float32}


def _weights(dtype_name: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scale = 0.02 if dtype_name != "float32" else 0.3
    return (rng.standard_normal(n) * scale).astype(NP_DTYPES[dtype_name])


def _tensor(a: np.ndarray) -> torch.Tensor:
    ints = {2: np.int16, 4: np.int32}[a.dtype.itemsize]
    return torch.from_numpy(a.view(ints).copy()).view(_util.torch_dtype(a.dtype.name))


@pytest.mark.parametrize("coder", ["huffman", "hufflib"])
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16", "float32"])
def test_blobs_byte_identical_to_reference(dtype_name, coder):
    a = _weights(dtype_name, 50_001, seed=len(dtype_name) * 10 + len(coder))
    kw = dict(chunk_param_bytes=1 << 14, backend=coder)
    want = ref_zipnn.compress_array(a, ref_zipnn.ZipNNConfig(**kw)).blob
    for threads in (0, 4):
        ct = zipnn.compress_array(
            _tensor(a), zipnn.ZipNNConfig(**kw), options=CodecOptions(threads=threads)
        )
        assert ct.blob == want, (dtype_name, coder, threads)
        assert ct.dtype == dtype_name and ct.shape == (50_001,)
    back = zipnn.decompress_array(ct, zipnn.ZipNNConfig(**kw))
    assert back.dtype == _util.torch_dtype(dtype_name)
    assert back.view(torch.uint8).numpy().tobytes() == a.tobytes()


def test_bytes_api_with_tail_matches_reference():
    """An unaligned tail rides the container's TAIL bytes in both."""
    raw = _weights("bfloat16", 4097, seed=5).tobytes() + b"\x2a"
    cfg = dict(chunk_param_bytes=1 << 13, backend="huffman")
    blob = zipnn.compress_bytes(raw, "bfloat16", zipnn.ZipNNConfig(**cfg))
    assert blob == ref_zipnn.compress_bytes(raw, "bfloat16", ref_zipnn.ZipNNConfig(**cfg))
    assert zipnn.decompress_bytes(blob) == raw


def _fixtures(kind=None):
    with open(os.path.join(FIXTURES, "meta.json")) as f:
        meta = json.load(f)
    return [fx for fx in meta["fixtures"] if fx["blob"].endswith(".znn")
            and (kind is None or fx["kind"] == kind)]


def _read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("fx", _fixtures(), ids=lambda fx: fx["name"])
def test_every_znn_fixture_decodes_bit_exactly(fx):
    blob, raw = _read(fx["blob"]), _read(fx["raw"])
    out = zipnn.decompress_bytes(blob, zipnn.ZipNNConfig(**fx["config"]))
    if fx["kind"] == "delta":
        # a delta blob holds the XOR stream; XOR with the base restores raw
        base = np.frombuffer(_read(fx["base"]), np.uint8)
        out = np.bitwise_xor(np.frombuffer(out, np.uint8), base).tobytes()
    assert out == raw


@pytest.mark.parametrize(
    "fx", [fx for fx in _fixtures("bytes") if fx["config"]["backend"] == "huffman"],
    ids=lambda fx: fx["name"],
)
def test_huffman_fixtures_reencode_byte_identically(fx):
    blob = zipnn.compress_bytes(
        _read(fx["raw"]), fx["dtype"], zipnn.ZipNNConfig(**fx["config"])
    )
    assert blob == _read(fx["blob"])


def test_pytree_manifest_matches_reference_leaf_order():
    """Nested dicts flatten in sorted-key order, as jax.tree_util does, so
    leaf i of both manifests is the same tensor with the same bytes."""
    rng = np.random.default_rng(3)
    tree = {
        "b": {"w": (rng.standard_normal((8, 16)) * 0.02).astype(ml_dtypes.bfloat16)},
        "a": {"z": rng.standard_normal(5).astype(np.float32),
              "g": (rng.standard_normal(16) * 0.02).astype(ml_dtypes.bfloat16)},
    }
    cfg = dict(chunk_param_bytes=1 << 12, backend="huffman")
    want = ref_zipnn.compress_pytree(tree, ref_zipnn.ZipNNConfig(**cfg))
    ttree = _util.tree_map(_tensor, tree)
    got = zipnn.compress_pytree(ttree, zipnn.ZipNNConfig(**cfg))
    assert [c.blob for c in got["leaves"]] == [c.blob for c in want["leaves"]]
    assert got["raw_bytes"] == want["raw_bytes"]
    assert got["comp_bytes"] == want["comp_bytes"]
    back = zipnn.decompress_pytree(got, zipnn.ZipNNConfig(**cfg))
    for a, b in zip(_util.tree_leaves(back), _util.tree_leaves(ttree)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_device_entry_points_need_a_card_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ct = zipnn.compress_array(torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zipnn.decompress_array(ct, device_resident=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zipnn.build_array_feed(ct)
    out = zipnn.decompress_array(ct, device_resident=True, device="cpu")
    assert out.device.type == "cpu" and torch.equal(out, torch.zeros(8, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# package independence
# ---------------------------------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_roots(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 15
    bad = [
        (os.path.relpath(p, ROOT), root)
        for p in files
        for root in _imported_roots(p)
        if root in _FORBIDDEN
    ]
    assert not bad, bad
