"""Device plane producer: the compression front half on the card (K3).

The host compression path runs three pre-entropy passes in numpy —
rotate + byte-group split (:mod:`.bitlayout`), the optional XOR delta, and
the per-chunk probe histograms — before the (plane, chunk) entropy work
items start.  This module runs all three in one launch of
:func:`repro_torch.kernels.plane_producer` on ``device`` (default
``"cuda"``) and downloads the planes and the per-chunk histograms once per
batch.  The planes and :class:`~.codec.ProbeStats` feed straight into
:meth:`.codec.PlaneCodec.plan`, which then histograms nothing.  Blobs are
byte-identical to the host path for every thread count.

Backends (the ``backend`` knob of :class:`.zipnn.ZipNNConfig`
(``plane_backend``) and of :class:`.options.CodecOptions`):

* ``"host"``   — always the numpy path (default);
* ``"device"`` — the K3 path whenever the (layout, chunk size) pair is in
  the envelope below, the host path otherwise (as the reference routes
  it).  With ``device="cuda"`` and no card it raises: there is no quiet
  host fallback;
* ``"auto"``   — the K3 path for tensors already on a CUDA device, and for
  host bytes when ``device`` is a card that is present
  (:func:`.options.resolve_backend`).

Envelope: rotated 2- and 4-byte layouts (bf16 / fp16 / fp32) with a
per-plane chunk size that is a whole number of the reference's histogram
blocks (``chunk_bytes % 16384 == 0``; the paper's 256 KiB parameter chunks
qualify).  fp8, int8 and the unrotated layouts stay on the host.

:func:`produce_planes_batched` packs many same-layout tensors into one
launch.  Each tensor is zero-padded to whole codec chunks, so no chunk
straddles two tensors; zero padding is invariant under rotate and XOR, so
the only correction is subtracting each tensor's pad count from bin 0 of
its final chunk's histograms.  Tensors already on ``device`` are read in
place: their raw values never go to the host, only their planes do.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _util
from ..kernels import plane_producer
from ..kernels.fused_plane import CHUNK_ALIGN_BYTES, ELEM_DTYPES
from . import bitlayout, codec

__all__ = [
    "DEFAULT_BATCH_BYTES",
    "MAX_BATCH_BYTES",
    "PlanedArray",
    "supports",
    "produce_planes",
    "produce_planes_batched",
]

DEFAULT_BATCH_BYTES = 256 << 20


def _batch_bytes_from_env(default: int = DEFAULT_BATCH_BYTES) -> int:
    """The launch-window cap: ``ZIPNN_MAX_BATCH_BYTES`` when it is set, a
    positive integer (plain or ``0x``-prefixed), else ``default``; any
    other value raises ``ValueError``.

    Read once, at import.  Launches split on chunk boundaries and payload
    bytes are per chunk, so the cap moves time and peak memory only, never
    a byte."""
    raw = os.environ.get("ZIPNN_MAX_BATCH_BYTES")
    if raw is None:
        return default
    try:
        value = int(raw, 0)
    except ValueError:
        raise ValueError(
            f"ZIPNN_MAX_BATCH_BYTES={raw!r} is not an integer byte count"
        ) from None
    if value <= 0:
        raise ValueError(f"ZIPNN_MAX_BATCH_BYTES must be positive, got {value}")
    return value


# One launch is capped so the packed elements and their planes stay well
# inside device memory; larger groups split into several launches.  Chunks
# never straddle tensors, so the split cannot change any byte.
MAX_BATCH_BYTES = _batch_bytes_from_env()


class PlanedArray(np.ndarray):
    """Host plane bytes that also carry their device-resident twin.

    ``dev_chunks`` is the same plane as a ``(n_chunks, chunk_bytes)`` uint8
    tensor on the producing device, zero-padded to whole chunks — the exact
    symbol rows the bit-pack kernel (K7) consumes — so
    :func:`.device_entropy.encode_planes` gathers HUFF symbols there
    instead of uploading them again.

    Any slice, view or ufunc result drops the twin
    (``__array_finalize__``): the pairing holds only for the whole plane.
    """

    def __array_finalize__(self, obj) -> None:
        self.dev_chunks = None


def supports(layout: bitlayout.BitLayout, params: codec.CodecParams) -> bool:
    """Can K3 produce byte-identical planes and probes for this leaf?"""
    if not layout.rotate or layout.sub_byte or layout.itemsize not in ELEM_DTYPES:
        return False
    return params.chunk_bytes % CHUNK_ALIGN_BYTES == 0


def _elems(buf: Any, layout: bitlayout.BitLayout) -> torch.Tensor:
    """``buf`` → flat element bits (int16 / int32), on the device it lies on.

    Takes a host uint8 byte buffer (the bytes API) or a tensor of a dtype
    of the layout's width; a tensor is only viewed, never copied.
    """
    dt = ELEM_DTYPES[layout.itemsize]
    if isinstance(buf, np.ndarray):
        if buf.dtype != np.uint8 or buf.size % layout.itemsize:
            raise ValueError(
                f"byte buffer of {buf.size} {buf.dtype} is not whole "
                f"{layout.itemsize}-byte elements"
            )
        return torch.from_numpy(np.array(buf, copy=True).view(f"<i{layout.itemsize}"))
    if buf.element_size() != layout.itemsize:
        raise TypeError(
            f"dtype {buf.dtype} does not match layout itemsize {layout.itemsize}"
        )
    return buf.detach().reshape(-1).view(dt)


PlanesAndProbes = Tuple[List[np.ndarray], List[Optional[codec.ProbeStats]]]


def produce_planes(
    buf: Any,
    layout: bitlayout.BitLayout,
    params: codec.CodecParams,
    base: Any = None,
    device: Any = "cuda",
) -> PlanesAndProbes:
    """One leaf through :func:`produce_planes_batched`.  ``base`` enables
    the fused XOR-delta path (``buf ^ base`` is planed instead of ``buf``;
    the rotation is a bit permutation, so it commutes with XOR)."""
    return produce_planes_batched(
        [buf], layout, params, bases=None if base is None else [base], device=device
    )[0]


def _empty(layout: bitlayout.BitLayout) -> PlanesAndProbes:
    return [np.empty(0, np.uint8) for _ in range(layout.n_planes)], [None] * layout.n_planes


def produce_planes_batched(
    bufs: Sequence[Any],
    layout: bitlayout.BitLayout,
    params: codec.CodecParams,
    bases: Optional[Sequence[Any]] = None,
    device: Any = "cuda",
) -> List[PlanesAndProbes]:
    """Plane many same-layout leaves in one K3 launch on ``device``;
    returns per-leaf ``(planes, probes)``.

    ``bufs`` are tensors (on any device) or host uint8 byte buffers;
    ``bases`` pair with them for the delta path (None entries: no base).
    The leaves are copied into one zero-padded element buffer on
    ``device``, one launch planes and histograms them, and the planes and
    histograms come back to the host in one download each.  Every leaf's
    host plane is a :class:`PlanedArray` whose twin stays on ``device``.
    Batches above :data:`MAX_BATCH_BYTES` split into several launches.
    """
    if bases is not None and len(bases) != len(bufs):
        raise ValueError("bases must pair 1:1 with bufs")
    if not bufs:
        return []
    if not supports(layout, params):
        raise ValueError(
            f"device plane backend does not support layout {layout.name!r} "
            f"with chunk_bytes={params.chunk_bytes}"
        )
    dev = _util.resolve_device(device)
    us = [_elems(b, layout) for b in bufs]
    bs = [None if b is None else _elems(b, layout) for b in bases] if bases else [None] * len(us)
    for u, b in zip(us, bs):
        if b is not None and b.numel() != u.numel():
            raise ValueError("delta base must match the leaf's element count")
    sizes = [u.numel() for u in us]
    if len(us) > 1 and sum(sizes) * layout.itemsize > MAX_BATCH_BYTES:
        out: List[PlanesAndProbes] = []
        start, acc = 0, 0
        for i, s in enumerate(sizes):
            nb = s * layout.itemsize
            if acc and acc + nb > MAX_BATCH_BYTES:
                out.extend(_produce(us[start:i], bs[start:i], layout, params, dev))
                start, acc = i, 0
            acc += nb
        out.extend(_produce(us[start:], bs[start:], layout, params, dev))
        return out
    return _produce(us, bs, layout, params, dev)


def _produce(
    us: Sequence[torch.Tensor],
    bs: Sequence[Optional[torch.Tensor]],
    layout: bitlayout.BitLayout,
    params: codec.CodecParams,
    dev: torch.device,
) -> List[PlanesAndProbes]:
    cb = params.chunk_bytes                    # elements per (plane) chunk
    sizes = [u.numel() for u in us]
    pads = [-s % cb for s in sizes]
    total = sum(s + p for s, p in zip(sizes, pads))
    if total == 0:                              # every leaf empty: no launch
        return [_empty(layout) for _ in sizes]
    dt = ELEM_DTYPES[layout.itemsize]
    x = torch.zeros(total, dtype=dt, device=dev)
    base = torch.zeros(total, dtype=dt, device=dev) if any(b is not None for b in bs) else None
    off = 0
    for u, b, s, pad in zip(us, bs, sizes, pads):
        x[off : off + s].copy_(u)
        if b is not None:
            base[off : off + s].copy_(b)
        off += s + pad

    planes_dev, hists_dev = plane_producer(
        x, base, itemsize=layout.itemsize, chunk_elems=cb
    )
    # The downloads of the batch: planes and probe histograms.  .cpu()
    # waits for the launch on the current stream.
    planes_host = planes_dev.cpu().numpy()
    hists = hists_dev.cpu().numpy().astype(np.int64)   # (chunks, n_planes, 256)

    out: List[PlanesAndProbes] = []
    off = choff = 0
    for s, pad in zip(sizes, pads):
        if s == 0:
            out.append(_empty(layout))
            continue
        n_chunks = (s + pad) // cb
        leaf_planes: List[np.ndarray] = []
        for p in range(layout.n_planes):
            host = planes_host[p, off : off + s].view(PlanedArray)
            host.dev_chunks = planes_dev[p, off : off + s + pad].view(n_chunks, cb)
            leaf_planes.append(host)
        leaf_h = hists[choff : choff + n_chunks].copy()
        if pad:
            leaf_h[-1, :, 0] -= pad            # padding is all-zero bytes
        probes: List[Optional[codec.ProbeStats]] = [
            codec.ProbeStats(
                chunk_hists=leaf_h[:, p, :],
                table_hist=codec.table_probe_hist(leaf_planes[p]),
            )
            for p in range(layout.n_planes)
        ]
        out.append((leaf_planes, probes))
        off += s + pad
        choff += n_chunks
    return out
