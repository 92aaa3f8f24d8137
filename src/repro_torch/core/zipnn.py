"""ZipNN public API on PyTorch tensors: lossless compression of model weights.

Pipeline per tensor (paper §3):

    raw bytes ──rotate+byte-group──▶ planes ──chunk──▶ probe ──▶ entropy code
                                     │                     │
                                     └ plane 0 = exponent  └ STORE/ZERO/HUFF/ZLIB

Entry points:
  * :func:`compress_bytes` / :func:`decompress_bytes` — raw little-endian
    streams with an explicit dtype interpretation (host).
  * :func:`compress_array` / :func:`decompress_array` — one tensor.
    ``decompress_array(..., device_resident=True)`` decodes on ``device``
    (default ``"cuda"``): K1 decodes the Huffman chunks and K2 rebuilds the
    elements there, so only the compressed payload crosses host→device.
  * :func:`compress_pytree` / :func:`decompress_pytree` — nested dicts of
    tensors (leaves in sorted-key order); returns a manifest.
  * :func:`build_array_feed` → :class:`ArrayFeed` — one tensor's payloads
    resident on the device, decoded again on every call with no payload
    upload (the compressed-resident serving ring's path).

Blobs are byte-identical to the reference implementation's
``repro.core.zipnn`` for the same bytes and config; ``options.threads``
fans (plane, chunk) work items across a pool and never changes bytes.
Encode runs on the host.  Delta streams and the file engine are not part
of this package yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import _util
from . import bitlayout, codec, container, device_entropy, device_unplane, engine
from .options import CodecOptions, resolve_options

__all__ = [
    "ZipNNConfig",
    "CodecOptions",
    "CompressedTensor",
    "ArrayFeed",
    "build_array_feed",
    "compress_array",
    "decompress_array",
    "compress_bytes",
    "decompress_bytes",
    "compress_pytree",
    "decompress_pytree",
]


@dataclasses.dataclass
class ZipNNConfig:
    """User-facing knobs (defaults = paper defaults)."""

    chunk_param_bytes: int = 1 << 18     # 256 KiB of parameters per chunk
    # Entropy coder. Both are Huffman-only coders (the ZipNN algorithm);
    # 'hufflib' uses zlib's C Huffman for production speed, 'huffman' is
    # the from-scratch canonical coder whose chunks the device decoder
    # (kernel K1) reads.
    backend: str = "hufflib"
    incompressible: float = 0.98
    skip_chunks: int = 8
    zlib_level: int = 6
    # Parallelism: 0/1 = serial, N > 1 = N pool workers, -1 = all cores.
    # Blob bytes are identical for every setting.
    threads: int = 0

    def plane_params(self, itemsize: int) -> codec.CodecParams:
        return codec.CodecParams(
            chunk_bytes=max(1, self.chunk_param_bytes // max(itemsize, 1)),
            incompressible=self.incompressible,
            skip_chunks=self.skip_chunks,
            backend=self.backend,
            zlib_level=self.zlib_level,
        )


DEFAULT = ZipNNConfig()


@dataclasses.dataclass
class CompressedTensor:
    """A compressed leaf: blob + enough info to restore dtype/shape."""

    blob: bytes
    dtype: str
    shape: Tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return len(self.blob)


def _pool(config: ZipNNConfig, opts: CodecOptions):
    return engine.get_pool(config.threads if opts.threads is None else opts.threads)


# ---------------------------------------------------------------------------
# byte streams (host)
# ---------------------------------------------------------------------------

def compress_bytes(
    raw: Union[bytes, bytearray, memoryview, np.ndarray],
    dtype_name: str,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
) -> bytes:
    """Compress a raw little-endian byte stream interpreted as ``dtype_name``."""
    opts = resolve_options(options)
    if isinstance(raw, (bytes, memoryview, bytearray)):
        buf = np.frombuffer(raw, dtype=np.uint8)
    else:
        buf = np.ascontiguousarray(raw, dtype=np.uint8)
    layout = bitlayout.layout_for(dtype_name)
    tail = buf.size % layout.align
    body, rem = (buf[: buf.size - tail], buf[buf.size - tail :]) if tail else (buf, None)
    pool = _pool(config, opts)
    params = config.plane_params(layout.itemsize)
    planes = bitlayout.to_planes(body, layout, pool=pool)
    tables: List[Optional[bytes]] = []
    entries: List[List[codec.ChunkEntry]] = []
    payloads: List[List[bytes]] = []
    for plane in planes:
        e, p, t = codec.compress_plane(plane, params, pool=pool)
        entries.append(e)
        payloads.append(p)
        tables.append(t)
    blob = container.pack_stream(
        layout.name, body.size, params.chunk_bytes, tables, entries, payloads
    )
    if rem is not None and rem.size:
        blob += b"TAIL" + bytes(rem)
    return blob


def _parse(blob: bytes):
    """Container parse: (meta, layout, per-plane payload lists, tail bytes)."""
    meta, mv = container.unpack_stream(blob)
    layout = bitlayout.layout_by_name(meta.layout_name)
    payload_lists = [
        [container.payload_view(meta, mv, p, c) for c in range(len(meta.entries[p]))]
        for p in range(meta.n_planes)
    ]
    end = meta.payload_base + sum(e.comp_len for pe in meta.entries for e in pe)
    tail = blob[end:]
    return meta, layout, payload_lists, (tail[4:] if tail[:4] == b"TAIL" else b"")


def decompress_bytes(
    blob: bytes,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
) -> bytes:
    """Decompress one ZNN1 blob back to its raw little-endian byte stream."""
    opts = resolve_options(options)
    pool = _pool(config, opts)
    meta, layout, payload_lists, tail = _parse(blob)
    params = codec.CodecParams(chunk_bytes=meta.chunk_bytes, backend=config.backend)
    planes = [
        codec.decompress_plane(
            meta.entries[p], payload_lists[p], meta.tables[p], params, pool=pool
        )
        for p in range(meta.n_planes)
    ]
    body = bitlayout.from_planes(tuple(planes), layout, pool=pool)
    return body.tobytes() + tail


# ---------------------------------------------------------------------------
# tensors
# ---------------------------------------------------------------------------

def _raw_view(t: torch.Tensor) -> np.ndarray:
    """A tensor's little-endian bytes as a host uint8 array."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8).numpy()


def _from_raw(raw: bytes, dtype: str, shape: Tuple[int, ...]) -> torch.Tensor:
    if not raw:
        return torch.empty(shape, dtype=_util.torch_dtype(dtype))
    u8 = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return u8.view(_util.torch_dtype(dtype)).reshape(shape)


def compress_array(
    arr: torch.Tensor,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
) -> CompressedTensor:
    """Compress one tensor (on any device; its bytes are read on the host)."""
    name = _util.dtype_name(arr.dtype)
    blob = compress_bytes(_raw_view(arr), name, config, options=options)
    return CompressedTensor(blob, name, tuple(arr.shape))


def _device_stream(ct: CompressedTensor, config: ZipNNConfig):
    """``(meta, layout, payload lists, params)`` of a leaf that can ride the
    device decode path end to end, or None (unsupported layout, empty
    leaf, tail bytes, a chunk geometry the device path cannot take)."""
    layout = bitlayout.LAYOUTS.get(ct.dtype)
    if layout is None or not device_unplane.supports(layout):
        return None
    if not int(np.prod(ct.shape, dtype=np.int64)):
        return None
    meta, blob_layout, payload_lists, tail = _parse(ct.blob)
    if tail or blob_layout.name != layout.name or not meta.entries:
        return None
    if not device_entropy.supports_decode(meta.chunk_bytes):
        return None
    params = codec.CodecParams(chunk_bytes=meta.chunk_bytes, backend=config.backend)
    return meta, layout, payload_lists, params


def _decompress_array_device(
    ct: CompressedTensor, config: ZipNNConfig, opts: CodecOptions, dev: torch.device
) -> Optional[torch.Tensor]:
    """Decode one leaf on ``dev`` with K1 + K2; None when the leaf cannot
    ride the device path, in which case the caller decodes on the host."""
    stream = _device_stream(ct, config)
    if stream is None:
        return None
    meta, layout, payload_lists, params = stream
    elems = device_unplane.consume_payloads(
        meta.entries, payload_lists, meta.tables, params, layout,
        pool=_pool(config, opts), device=dev,
    )
    return elems.view(_util.torch_dtype(ct.dtype)).reshape(ct.shape)


def decompress_array(
    ct: CompressedTensor,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
    device_resident: Optional[bool] = None,
    device: Any = "cuda",
) -> torch.Tensor:
    """Decompress one leaf back to its dtype/shape.

    Returns a CPU tensor by default.  ``device_resident=True`` (kwarg or
    options field) returns it on ``device``, decoded there by K1 + K2 when
    the layout allows (bf16/fp16/fp32); other leaves decode on the host
    and are copied over.  Bits are identical either way.
    """
    opts = resolve_options(options, device_resident=device_resident)
    if opts.device_resident:
        dev = _util.resolve_device(device)
        out = _decompress_array_device(ct, config, opts, dev)
        if out is not None:
            return out
        return decompress_array(ct, config, options=opts.replace(device_resident=False)).to(dev)
    raw = decompress_bytes(ct.blob, config, options=opts)
    return _from_raw(raw, ct.dtype, tuple(ct.shape))


# ---------------------------------------------------------------------------
# device-resident payload feed (per leaf)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ArrayFeed:
    """One leaf's device-resident decode plan: blob parsed once, payloads
    resident on the device, :meth:`decode` re-runs K1 and K2 from those
    buffers on every call — zero host→device payload traffic per decode
    (see :class:`.device_entropy.PayloadFeed`).  Decoded tensors are
    bit-identical to ``decompress_array(ct, device_resident=True)``.
    """

    dtype: str
    shape: Tuple[int, ...]
    _feed: device_entropy.PayloadFeed
    _layout: bitlayout.BitLayout

    @property
    def device_bytes(self) -> int:
        """Resident device footprint of the feed (payload words, splice,
        LUT rows, per-chunk index arrays)."""
        return self._feed.device_bytes

    @property
    def n_launches(self) -> Dict[str, int]:
        """Kernel launches per :meth:`decode`."""
        return {"huffdecode_chunks": self._feed.n_launches, "plane_consumer": 1}

    def launch_args(self) -> Optional[Dict[str, Any]]:
        """The resident K1 inputs of one decode (see
        :meth:`.device_entropy.PayloadFeed.launch_args`)."""
        return self._feed.launch_args()

    def decode(self) -> torch.Tensor:
        """The restored leaf on the feed's device."""
        planes = self._feed.decode()
        elems = device_unplane.consume_planes(planes, self._layout)
        return elems.view(_util.torch_dtype(self.dtype)).reshape(self.shape)


def build_array_feed(
    ct: CompressedTensor,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
    device: Any = "cuda",
) -> Optional[ArrayFeed]:
    """Parse one leaf's blob into a device-resident :class:`ArrayFeed`.

    The container parse, CRC and cursor integrity checks, word packing and
    payload upload all happen here, once.  Returns ``None`` when the leaf
    cannot ride the device path end to end (unsupported layout, empty
    leaf, tail bytes); callers then decode per call.  ``options.threads``
    fans the build-time host work items and cannot change decoded bits.
    """
    opts = resolve_options(options)
    dev = _util.resolve_device(device)
    stream = _device_stream(ct, config)
    if stream is None:
        return None
    meta, layout, payload_lists, params = stream
    feed = device_entropy.PayloadFeed(
        meta.entries, payload_lists, meta.tables, params,
        pool=_pool(config, opts), device=dev,
    )
    return ArrayFeed(ct.dtype, tuple(ct.shape), feed, layout)


# ---------------------------------------------------------------------------
# pytrees
# ---------------------------------------------------------------------------

def compress_pytree(
    tree: Any,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
) -> Dict[str, Any]:
    """Compress every leaf of a nested dict of tensors; returns a manifest.

    Leaves are walked in sorted-key order, so the manifest layout is
    deterministic and matches the reference's leaf order.
    """
    leaves, treedef = _util.tree_flatten(tree)
    comp = [compress_array(leaf, config, options=options) for leaf in leaves]
    return {
        "treedef": treedef,
        "leaves": comp,
        "raw_bytes": sum(leaf.numel() * leaf.element_size() for leaf in leaves),
        "comp_bytes": sum(c.nbytes for c in comp),
    }


def decompress_pytree(
    manifest: Dict[str, Any],
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
    device_resident: Optional[bool] = None,
    device: Any = "cuda",
) -> Any:
    """Decompress every leaf of a :func:`compress_pytree` manifest (CPU
    tensors, or tensors on ``device`` with ``device_resident=True``)."""
    opts = resolve_options(options, device_resident=device_resident)
    arrays = [
        decompress_array(ct, config, options=opts, device=device)
        for ct in manifest["leaves"]
    ]
    return _util.tree_unflatten(manifest["treedef"], arrays)

