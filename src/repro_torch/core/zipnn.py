"""ZipNN public API on PyTorch tensors: lossless compression of model weights.

Pipeline per tensor (paper §3):

    raw bytes ──rotate+byte-group──▶ planes ──chunk──▶ probe ──▶ entropy code
                                     │                     │
                                     └ plane 0 = exponent  └ STORE/ZERO/HUFF/ZLIB

Entry points:
  * :func:`compress_bytes` / :func:`decompress_bytes` — raw little-endian
    streams with an explicit dtype interpretation.
  * :func:`compress_array` / :func:`decompress_array` — one tensor.
    ``decompress_array(..., device_resident=True)`` decodes on ``device``
    (default ``"cuda"``): K1 decodes the Huffman chunks and K2 rebuilds the
    elements there, so only the compressed payload crosses host→device.
  * :func:`compress_pytree` / :func:`decompress_pytree` — nested dicts of
    tensors (leaves in sorted-key order); returns a manifest.
  * :func:`delta_compress` / :func:`delta_compress_batched` /
    :func:`delta_decompress` — §4.2 XOR deltas against a base tensor.
  * :func:`build_array_feed` → :class:`ArrayFeed` — one tensor's payloads
    resident on the device, decoded again on every call with no payload
    upload (the compressed-resident serving ring's path).
  * :func:`compress_file` / :func:`decompress_file`,
    :class:`CompressWriter` / :class:`DecompressReader` (from
    :mod:`.engine`) — ZNS1 streams of ZNN1 frames, O(window) memory.
  * :func:`compressed_size` / :func:`ratio`; :class:`ZipNNSession` (from
    :mod:`.options`) binds a config and options for the whole surface.

Every entry point takes ``options`` (:class:`CodecOptions`) and ``device=``
(default ``"cuda"``).  ``options.backend`` (default: the config's
``plane_backend``, ``"auto"``) chooses where the plane stage runs on
encode: ``"host"`` runs rotate / byte-group / probe in numpy; ``"device"``
runs them as one launch of K3 on ``device`` (:mod:`.device_plane`), with
the XOR of a delta fused in; ``"auto"`` picks the device for tensors
already on a CUDA device, and for host bytes (:func:`compress_bytes`, so
every file frame) when ``device`` is a card that is present
(:func:`.options.resolve_backend`).  ``options.entropy_backend`` (default: the
config's ``entropy_backend``, then the plane backend) does the same for
the Huffman bit-packing of the planned ``HUFF`` chunks, with K7
(:mod:`.device_entropy`); only the canonical ``huffman`` coder has a
device form.

Decode takes the same knobs: the entropy stage decodes a blob's ``HUFF``
chunks with K1 on ``device`` and the back half (un-group, inverse rotate,
inverse XOR) runs as K2 (:mod:`.device_unplane`), each when its knob asks
for the device, or under ``"auto"`` when ``device`` is a card that is
present.  Leaves outside a stage's envelope take the host path for that
stage, as the reference routes them; a stage routed to the device with
``device="cuda"`` and no card raises, and a kernel that fails raises:
nothing falls back to the host quietly.

Blobs are byte-identical to the reference implementation's
``repro.core.zipnn`` for the same bytes and config, across ``backend`` ×
``entropy_backend`` × ``threads``; ``options.threads`` fans (plane, chunk)
work items across a pool.  Decoded bits are identical on every route.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import _util, trace
from ..kernels.fused_unplane import ELEM_DTYPES
from . import (
    bitlayout, codec, container, device_entropy, device_plane, device_unplane, engine,
)
from .engine import (             # noqa: F401  (re-exported streaming API)
    CompressWriter,
    DecompressReader,
    compress_file,
    decompress_file,
)
from .options import (            # noqa: F401  (ZipNNSession re-exported)
    CodecOptions,
    ZipNNSession,
    resolve_backend,
    resolve_options,
)

__all__ = [
    "ZipNNConfig",
    "CodecOptions",
    "ZipNNSession",
    "CompressedTensor",
    "ArrayFeed",
    "build_array_feed",
    "compress_array",
    "decompress_array",
    "compress_bytes",
    "decompress_bytes",
    "compress_pytree",
    "decompress_pytree",
    "delta_compress",
    "delta_compress_batched",
    "delta_decompress",
    "compress_file",
    "decompress_file",
    "CompressWriter",
    "DecompressReader",
    "compressed_size",
    "ratio",
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
    # Plane stage: 'host' (numpy), 'device' (K3 where the layout and chunk
    # size allow it) or 'auto' (device for leaves on a CUDA device, and for
    # decode when the entry point's device is a card that is present).
    # Bytes are equal on every backend: 'auto' chooses where work runs.
    plane_backend: str = "auto"
    # Bit-pack stage: None follows plane_backend; otherwise as above, with
    # K7 for the canonical 'huffman' coder only.
    entropy_backend: Optional[str] = None

    def plane_params(self, itemsize: int, delta: bool = False) -> codec.CodecParams:
        return codec.CodecParams(
            chunk_bytes=max(1, self.chunk_param_bytes // max(itemsize, 1)),
            incompressible=self.incompressible,
            skip_chunks=self.skip_chunks,
            delta_mode=delta,
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
# backend resolution
# ---------------------------------------------------------------------------

def _plane_request(config: ZipNNConfig, opts: CodecOptions) -> str:
    return config.plane_backend if opts.backend is None else opts.backend


def _entropy_request(config: ZipNNConfig, opts: CodecOptions) -> str:
    """``options.entropy_backend``, then the config's, then the plane
    request: ``backend="device"`` means both stages on the device unless
    the entropy knob says otherwise (mixed mode)."""
    for requested in (opts.entropy_backend, config.entropy_backend):
        if requested is not None:
            return requested
    return _plane_request(config, opts)


def _plane_backend(config, opts, layout, params, leaf=None, device="cuda") -> str:
    return resolve_backend(
        _plane_request(config, opts), device_plane.supports(layout, params), leaf, device,
        "plane",
    )


def _entropy_backend(config, opts, layout, params, leaf=None, device="cuda") -> str:
    return resolve_backend(
        _entropy_request(config, opts), device_entropy.supports(layout, params), leaf, device,
        "entropy",
    )


def _host_planes(opts: CodecOptions, entropy: str) -> CodecOptions:
    """``opts`` for a leaf whose plane stage was resolved to the host and
    whose entropy stage was resolved to ``entropy``."""
    return opts.replace(backend="host", entropy_backend=entropy)


# ---------------------------------------------------------------------------
# byte streams
# ---------------------------------------------------------------------------

def _entropy_stage(
    planes: List[np.ndarray],
    probes: List[Optional[codec.ProbeStats]],
    layout: bitlayout.BitLayout,
    body_bytes: int,
    rem: Optional[np.ndarray],
    params: codec.CodecParams,
    pool,
    delta: bool,
    entropy: str,
    device: Any,
) -> bytes:
    """Shared back half of every compression path: (plane, chunk) entropy
    work items + container packing.  ``planes`` come from the host split
    or K3; ``probes`` carry K3's histograms (None: the host probes).
    ``entropy="device"`` packs the planned HUFF chunks of all planes with
    K7 on ``device``; blobs are byte-identical either way."""
    if entropy == "device" and planes:
        entries, payloads, tables = device_entropy.encode_planes(
            planes, probes, params, pool=pool, device=device
        )
    else:
        entries, payloads, tables = [], [], []
        for plane, probe in zip(planes, probes):
            e, p, t = codec.compress_plane(plane, params, pool=pool, probe=probe)
            entries.append(e)
            payloads.append(p)
            tables.append(t)
    blob = container.pack_stream(
        layout.name, body_bytes, params.chunk_bytes, tables, entries, payloads,
        delta=delta,
    )
    if rem is not None and rem.size:
        blob += b"TAIL" + bytes(rem)
    return blob


def compress_bytes(
    raw: Union[bytes, bytearray, memoryview, np.ndarray],
    dtype_name: str,
    config: ZipNNConfig = DEFAULT,
    *,
    delta: bool = False,
    options: Optional[CodecOptions] = None,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    device: Any = "cuda",
) -> bytes:
    """Compress a raw little-endian byte stream interpreted as ``dtype_name``
    (``delta=True``: the stream is an XOR delta, coded with the §4.2
    method choice)."""
    opts = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend
    )
    if isinstance(raw, (bytes, memoryview, bytearray)):
        buf = np.frombuffer(raw, dtype=np.uint8)
    else:
        buf = np.ascontiguousarray(raw, dtype=np.uint8)
    layout = bitlayout.layout_for(dtype_name)
    tail = buf.size % layout.align
    body, rem = (buf[: buf.size - tail], buf[buf.size - tail :]) if tail else (buf, None)
    pool = _pool(config, opts)
    params = config.plane_params(layout.itemsize, delta)
    if body.size and _plane_backend(config, opts, layout, params, device=device) == "device":
        planes, probes = device_plane.produce_planes(body, layout, params, device=device)
    else:
        planes = list(bitlayout.to_planes(body, layout, pool=pool))
        probes = [None] * len(planes)
    entropy = (
        _entropy_backend(config, opts, layout, params, device=device) if body.size else "host"
    )
    return _entropy_stage(
        planes, probes, layout, body.size, rem, params, pool, delta, entropy, device
    )


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


def _decode_backend(config, opts, layout, device) -> str:
    """The decode back half (K2's un-group, inverse rotate, inverse XOR):
    'host' or 'device'.  A blob is host bytes, so ``"auto"`` keys off
    ``device`` being a card that is present."""
    return resolve_backend(
        _plane_request(config, opts), device_unplane.supports(layout), None, device, "plane"
    )


def _decode_entropy(config, opts, chunk_bytes, device) -> str:
    """The decode entropy stage (K1 on the HUFF chunks): same precedence
    as the encode side — ``options.entropy_backend``, the config's, then
    the plane request."""
    return resolve_backend(
        _entropy_request(config, opts), device_entropy.supports_decode(chunk_bytes),
        None, device, "entropy",
    )


Planes = List[Union[np.ndarray, torch.Tensor]]


def _entropy_decode(
    blob: bytes, config: ZipNNConfig, opts: CodecOptions, pool, device: Any
) -> Tuple[bitlayout.BitLayout, Planes, bytes]:
    """Front half of every decode: parse the container and entropy-decode
    every (plane, chunk) payload.  Returns ``(layout, planes, tail)``; the
    planes are host uint8 arrays, or uint8 tensors on ``device`` when K1
    decoded them (only when the stream has HUFF chunks and the entropy
    stage resolves to the device)."""
    meta, layout, payload_lists, tail = _parse(blob)
    params = codec.CodecParams(chunk_bytes=meta.chunk_bytes, backend=config.backend)
    huff = any(e.method == codec.Method.HUFF for pe in meta.entries for e in pe)
    if huff and _decode_entropy(config, opts, meta.chunk_bytes, device) == "device":
        planes: Planes = device_entropy.decode_planes(
            meta.entries, payload_lists, meta.tables, params, pool=pool, device=device,
            device_resident=True,
        )
    else:
        planes = [
            codec.decompress_plane(
                meta.entries[p], payload_lists[p], meta.tables[p], params, pool=pool
            )
            for p in range(meta.n_planes)
        ]
    return layout, planes, tail


def _numel(plane) -> int:
    return plane.numel() if isinstance(plane, torch.Tensor) else plane.size


def _on_device(planes: Planes, dev: torch.device) -> List[torch.Tensor]:
    """Planes as uint8 tensors on ``dev`` (host planes uploaded once)."""
    return [
        p.to(dev) if isinstance(p, torch.Tensor) else torch.from_numpy(p).to(dev)
        for p in planes
    ]


def decompress_bytes(
    blob: bytes,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    device: Any = "cuda",
) -> bytes:
    """Decompress one ZNN1 blob back to its raw little-endian byte stream.

    The HUFF chunks decode with K1 and the planes become elements with K2
    on ``device`` when the knobs resolve there (see the module docstring);
    only the elements come back.  Bytes are identical on every route.
    """
    opts = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend
    )
    pool = _pool(config, opts)
    layout, planes, tail = _entropy_decode(blob, config, opts, pool, device)
    if planes and _numel(planes[0]) and _decode_backend(config, opts, layout, device) == "device":
        dev = _util.resolve_device(device)
        elems = device_unplane.consume_planes(
            _on_device(planes, dev), layout, device_resident=True)
        body = elems.cpu().view(torch.uint8).numpy()
    else:
        host = [p.cpu().numpy() if isinstance(p, torch.Tensor) else p for p in planes]
        body = bitlayout.from_planes(tuple(host), layout, pool=pool)
    return body.tobytes() + tail


# ---------------------------------------------------------------------------
# tensors
# ---------------------------------------------------------------------------

def _raw_view(t: torch.Tensor) -> np.ndarray:
    """A tensor's little-endian bytes as a host uint8 array."""
    if not t.numel():              # an empty view may have stride 0: no byte view
        return np.zeros(0, dtype=np.uint8)
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8).numpy()


def _from_raw(raw: bytes, dtype: str, shape: Tuple[int, ...]) -> torch.Tensor:
    if not raw:
        return torch.empty(shape, dtype=_util.torch_dtype(dtype))
    u8 = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return u8.view(_util.torch_dtype(dtype)).reshape(shape)


def _leaf_layout(arr: torch.Tensor) -> Optional[bitlayout.BitLayout]:
    return bitlayout.LAYOUTS.get(_util.dtype_name(arr.dtype))


def _device_encode(
    leaves: List[torch.Tensor],
    bases: Optional[List[torch.Tensor]],
    layout: bitlayout.BitLayout,
    params: codec.CodecParams,
    config: ZipNNConfig,
    opts: CodecOptions,
    device: Any,
) -> List[bytes]:
    """Blobs of same-layout leaves (XORed with ``bases`` for a delta) whose
    plane stage is the device's: one K3 batch, then each leaf's entropy
    stage on its resolved backend."""
    with trace.span("encode.planes"):
        produced = device_plane.produce_planes_batched(
            leaves, layout, params, bases=bases, device=device
        )
    pool = _pool(config, opts)
    return [
        _entropy_stage(
            planes, probes, layout, leaf.numel() * layout.itemsize, None, params,
            pool, params.delta_mode,
            _entropy_backend(config, opts, layout, params, leaf=leaf), device,
        )
        for leaf, (planes, probes) in zip(leaves, produced)
    ]


def compress_array(
    arr: torch.Tensor,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    device: Any = "cuda",
) -> CompressedTensor:
    """Compress one tensor.

    On the host plane path its bytes are read on the host; on the device
    path (``options.backend``) K3 planes it on ``device`` — a tensor
    already there is read in place, and only its planes come back.
    """
    opts = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend
    )
    name = _util.dtype_name(arr.dtype)
    layout = _leaf_layout(arr)
    if layout is not None and arr.numel():
        params = config.plane_params(layout.itemsize)
        if _plane_backend(config, opts, layout, params, leaf=arr) == "device":
            blob = _device_encode([arr], None, layout, params, config, opts, device)[0]
            return CompressedTensor(blob, name, tuple(arr.shape))
        # resolved once against the leaf, before its bytes go to the host
        opts = _host_planes(opts, _entropy_backend(config, opts, layout, params, leaf=arr))
    blob = compress_bytes(_raw_view(arr), name, config, options=opts, device=device)
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
        pool=_pool(config, opts), device=dev, device_resident=True,
    )
    return elems.view(_util.torch_dtype(ct.dtype)).reshape(ct.shape)


def decompress_array(
    ct: CompressedTensor,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    device_resident: Optional[bool] = None,
    device: Any = "cuda",
) -> torch.Tensor:
    """Decompress one leaf back to its dtype/shape.

    Returns a CPU tensor by default.  ``device_resident=True`` (kwarg or
    options field) returns it on ``device``, decoded there by K1 + K2 when
    the layout allows (bf16/fp16/fp32); other leaves decode on the host
    and are copied over.  Bits are identical either way.
    """
    opts = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend,
        device_resident=device_resident,
    )
    if opts.device_resident:
        dev = _util.resolve_device(device)
        out = _decompress_array_device(ct, config, opts, dev)
        if out is not None:
            return out
        return decompress_array(ct, config, options=opts.replace(device_resident=False)).to(dev)
    raw = decompress_bytes(ct.blob, config, options=opts, device=device)
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
        with trace.span("feed.decode"):
            planes = self._feed.decode()
            elems = device_unplane.consume_planes(planes, self._layout, device_resident=True)
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

def _device_groups(leaves, config, opts, delta=False) -> Dict[str, List[int]]:
    """Indices of the leaves whose plane stage resolves to the device,
    grouped by dtype (one K3 batch per group)."""
    groups: Dict[str, List[int]] = {}
    if _plane_request(config, opts) == "host":
        return groups
    for i, leaf in enumerate(leaves):
        layout = _leaf_layout(leaf)
        if layout is None or not leaf.numel():
            continue
        params = config.plane_params(layout.itemsize, delta)
        if _plane_backend(config, opts, layout, params, leaf=leaf) == "device":
            groups.setdefault(_util.dtype_name(leaf.dtype), []).append(i)
    return groups


def _rest_on_host(opts: CodecOptions) -> CodecOptions:
    """``opts`` for the leaves a batched call left to the host plane path;
    their entropy stage still follows the request (mixed mode)."""
    entropy = opts.entropy_backend if opts.entropy_backend is not None else opts.backend
    return _host_planes(opts, entropy)


def compress_pytree(
    tree: Any,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """Compress every leaf of a nested dict of tensors; returns a manifest.

    Leaves are walked in sorted-key order, so the manifest layout is
    deterministic and matches the reference's leaf order.  With the device
    plane backend, same-dtype leaves share one K3 launch
    (:func:`.device_plane.produce_planes_batched`); each leaf's blob is the
    one it would get alone, on either backend.
    """
    opts = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend
    )
    leaves, treedef = _util.tree_flatten(tree)
    comp: List[Optional[CompressedTensor]] = [None] * len(leaves)
    for name, idxs in _device_groups(leaves, config, opts).items():
        layout = bitlayout.LAYOUTS[name]
        group = [leaves[i] for i in idxs]
        blobs = _device_encode(
            group, None, layout, config.plane_params(layout.itemsize), config, opts, device
        )
        for i, leaf, blob in zip(idxs, group, blobs):
            comp[i] = CompressedTensor(blob, name, tuple(leaf.shape))
    rest = _rest_on_host(opts)
    for i, leaf in enumerate(leaves):
        if comp[i] is None:
            comp[i] = compress_array(leaf, config, options=rest, device=device)
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
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    device_resident: Optional[bool] = None,
    device: Any = "cuda",
) -> Any:
    """Decompress every leaf of a :func:`compress_pytree` manifest (CPU
    tensors, or tensors on ``device`` with ``device_resident=True``).

    Leaves whose decode resolves to the card (the knobs, or
    ``device_resident``, which decodes both stages there) are grouped by
    layout: each leaf's HUFF chunks decode with K1, then one K2 launch
    (:func:`.device_unplane.consume_planes_batched`) rebuilds a window of
    up to :data:`.device_plane.MAX_BATCH_BYTES` of leaves at once.  Every
    leaf is bit-identical to decoding it alone; the rest (other layouts,
    tails, empty leaves) decode one by one.
    """
    opts = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend,
        device_resident=device_resident,
    )
    cts: List[CompressedTensor] = manifest["leaves"]
    arrays: List[Optional[torch.Tensor]] = [None] * len(cts)
    route = opts.replace(backend="device", entropy_backend="device") if opts.device_resident else opts
    groups: Dict[str, List[int]] = {}
    for i, ct in enumerate(cts):
        layout = bitlayout.LAYOUTS.get(ct.dtype)
        if layout is not None and _decode_backend(config, route, layout, device) == "device":
            groups.setdefault(ct.dtype, []).append(i)
    if groups:
        dev = _util.resolve_device(device)
        pool = _pool(config, opts)
    for name, idxs in groups.items():
        layout = bitlayout.LAYOUTS[name]
        window: List[Tuple[int, List[torch.Tensor]]] = []
        acc = 0

        def flush():
            elems = device_unplane.consume_planes_batched(
                [p for _, p in window], layout, device_resident=True)
            for (i, _), el in zip(window, elems):
                out = el.view(_util.torch_dtype(cts[i].dtype)).reshape(cts[i].shape)
                arrays[i] = out if opts.device_resident else out.cpu()
            window.clear()

        for i in idxs:
            blob_layout, planes, tail = _entropy_decode(cts[i].blob, config, route, pool, dev)
            if tail or blob_layout.name != layout.name or not planes or not _numel(planes[0]):
                continue                    # edge cases decode one by one below
            nb = _numel(planes[0]) * layout.itemsize
            if window and acc + nb > device_plane.MAX_BATCH_BYTES:
                flush()                     # split before the cap, as produce_planes does
                acc = 0
            window.append((i, _on_device(planes, dev)))
            acc += nb
        if window:
            flush()
    for i, ct in enumerate(cts):
        if arrays[i] is None:
            arrays[i] = decompress_array(ct, config, options=opts, device=device)
    return _util.tree_unflatten(manifest["treedef"], arrays)


# ---------------------------------------------------------------------------
# deltas (§4.2)
# ---------------------------------------------------------------------------

def _same_kind(a: torch.Tensor, b: torch.Tensor) -> bool:
    return tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype


def delta_compress(
    new: torch.Tensor,
    base: torch.Tensor,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    device: Any = "cuda",
) -> CompressedTensor:
    """XOR-delta two same-shape tensors and compress the delta stream.

    XOR, not subtraction: it is exactly reversible with no extra bits
    (paper §4.2).  The delta is byte-grouped like a tensor and each chunk
    picks Huffman or LZ by the §4.2 criteria.  On the device plane path
    the XOR is fused into K3 (the rotation is a bit permutation, so it
    commutes with XOR): the delta itself never exists, only its planes.
    """
    opts = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend
    )
    if not _same_kind(new, base):
        raise ValueError("delta requires matching shape/dtype")
    name = _util.dtype_name(new.dtype)
    layout = _leaf_layout(new)
    if layout is not None and new.numel():
        params = config.plane_params(layout.itemsize, delta=True)
        if _plane_backend(config, opts, layout, params, leaf=new) == "device":
            blob = _device_encode([new], [base], layout, params, config, opts, device)[0]
            return CompressedTensor(blob, name, tuple(new.shape))
        opts = _host_planes(opts, _entropy_backend(config, opts, layout, params, leaf=new))
    x = np.bitwise_xor(_raw_view(new), _raw_view(base))
    blob = compress_bytes(x, name, config, delta=True, options=opts, device=device)
    return CompressedTensor(blob, name, tuple(new.shape))


def delta_compress_batched(
    news: List[torch.Tensor],
    bases: List[torch.Tensor],
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    device: Any = "cuda",
) -> List[CompressedTensor]:
    """Delta-compress many ``(new, base)`` pairs; returns blobs in order.

    With the device plane backend, same-dtype pairs share one K3 launch
    with their bases; each blob equals :func:`delta_compress` of its pair
    alone, on either backend.
    """
    opts = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend
    )
    if len(news) != len(bases):
        raise ValueError("news and bases must pair 1:1")
    out: List[Optional[CompressedTensor]] = [None] * len(news)
    pairs = [i for i, (a, b) in enumerate(zip(news, bases)) if _same_kind(a, b)]
    groups = _device_groups([news[i] for i in pairs], config, opts, delta=True)
    for name, idxs in groups.items():
        idxs = [pairs[i] for i in idxs]
        layout = bitlayout.LAYOUTS[name]
        blobs = _device_encode(
            [news[i] for i in idxs], [bases[i] for i in idxs], layout,
            config.plane_params(layout.itemsize, delta=True), config, opts, device,
        )
        for i, blob in zip(idxs, blobs):
            out[i] = CompressedTensor(blob, name, tuple(news[i].shape))
    rest = _rest_on_host(opts)
    for i, (a, b) in enumerate(zip(news, bases)):
        if out[i] is None:                    # the host path raises on a mismatch
            out[i] = delta_compress(a, b, config, options=rest, device=device)
    return out


def delta_decompress(
    ct: CompressedTensor,
    base: torch.Tensor,
    config: ZipNNConfig = DEFAULT,
    *,
    options: Optional[CodecOptions] = None,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    device_resident: Optional[bool] = None,
    device: Any = "cuda",
) -> torch.Tensor:
    """Invert :func:`delta_compress`: decode the delta stream and XOR it
    with ``base``.

    With ``device_resident`` or a backend that asks for the device
    (``"device"``, or ``"auto"`` with a card present), K1 decodes the
    HUFF chunks and K2 un-groups, un-rotates and XORs the base on
    ``device``: only compressed bytes (and the base, when it lies
    elsewhere) go there.  The result stays on ``device`` with
    ``device_resident``, and comes back as a CPU tensor otherwise.  Leaves
    the device path cannot take decode on the host.  Bits are identical
    either way.
    """
    opts = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend,
        device_resident=device_resident,
    )
    if tuple(ct.shape) != tuple(base.shape) or ct.dtype != _util.dtype_name(base.dtype):
        raise ValueError("delta requires matching shape/dtype")
    layout = bitlayout.LAYOUTS.get(ct.dtype)
    if opts.device_resident or (
        layout is not None and _decode_backend(config, opts, layout, device) == "device"
    ):
        dev = _util.resolve_device(device)
        stream = _device_stream(ct, config)
        if stream is not None:
            meta, layout, payload_lists, params = stream
            b = base.detach().reshape(-1).view(ELEM_DTYPES[layout.itemsize])
            elems = device_unplane.consume_payloads(
                meta.entries, payload_lists, meta.tables, params, layout,
                base=b.to(dev), pool=_pool(config, opts), device=dev, device_resident=True,
            )
            out = elems.view(_util.torch_dtype(ct.dtype)).reshape(ct.shape)
            return out if opts.device_resident else out.cpu()
    # the XOR happens on the host here, so the back half is pinned there;
    # the entropy stage still follows the request
    host = _host_planes(opts, _entropy_request(config, opts))
    x = np.frombuffer(
        decompress_bytes(ct.blob, config, options=host, device=device), dtype=np.uint8
    )
    out = _from_raw(np.bitwise_xor(x, _raw_view(base)).tobytes(), ct.dtype, tuple(ct.shape))
    return out.to(_util.resolve_device(device)) if opts.device_resident else out


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def compressed_size(manifest_or_ct: Any) -> int:
    if isinstance(manifest_or_ct, CompressedTensor):
        return manifest_or_ct.nbytes
    return manifest_or_ct["comp_bytes"]


def ratio(raw_bytes: int, comp_bytes: int) -> float:
    """Compressed size in percent — lower is better (paper's metric)."""
    return 100.0 * comp_bytes / max(raw_bytes, 1)
