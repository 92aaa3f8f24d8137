"""Chunked plane codec: methods, auto-detection, per-chunk metadata map.

Implements the paper's §5.1 container semantics:

* fixed-size input chunks (default 256 KiB of parameters → per-plane chunks
  of ``chunk_size // itemsize`` bytes, i.e. 128 KiB for BF16, 64 KiB for
  FP32 — exactly the sizes quoted in the paper);
* independent per-(chunk, plane) payloads + a metadata map so decompression
  parallelizes at both chunk and byte-group granularity;
* compressibility probing with probe-skip (§3.2 "Identifying
  compressibility"): incompressible planes/chunks are stored raw and the
  next ``skip_chunks`` chunks skip the probe;
* per-chunk method auto-selection for delta streams (§4.2 "Auto Detection"):
  Zstd-class LZ beats Huffman when zeros > 90 % of a chunk or a zero run
  exceeds 3 % of the chunk — we implement the same two criteria with zlib as
  the LZ+entropy coder.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import huffman

__all__ = [
    "Method",
    "ChunkEntry",
    "PlaneCodec",
    "CodecParams",
    "ProbeStats",
    "compress_plane",
    "decompress_plane",
    "longest_zero_run",
    "split_ids",
    "table_probe_hist",
]

# Work-item granularity for the thread-pool paths: several batches per
# worker so a slow batch (e.g. one with every HUFF chunk) cannot serialize
# the tail of the schedule.
_BATCHES_PER_WORKER = 4


def split_ids(n_items: int, n_parts: int) -> List[range]:
    """Partition ``range(n_items)`` into ≤ ``n_parts`` contiguous ranges.

    Contiguity keeps each work item operating on one dense slice of the
    plane (cache-friendly) and makes result concatenation order-preserving —
    the pool path's output is byte-identical to the serial path's.
    """
    if n_items <= 0:
        return []
    n_parts = max(1, min(n_parts, n_items))
    step = -(-n_items // n_parts)
    return [range(i, min(i + step, n_items)) for i in range(0, n_items, step)]


def _fan_out(pool, n_items: int, work) -> List:
    """Run ``work(ids)`` over all of ``range(n_items)``, fanning contiguous
    id batches across ``pool`` (serial when ``pool`` is None or trivial).

    Batch results are concatenated in id order — the determinism contract.
    ``work`` may return None for pure side-effect items (disjoint writes);
    the empty list is returned in that case.
    """
    if pool is None or n_items < 2:
        out = work(range(n_items))
        return [] if out is None else list(out)
    workers = getattr(pool, "_max_workers", None) or 1
    batches = split_ids(n_items, workers * _BATCHES_PER_WORKER)
    results = list(pool.map(work, batches))
    if results and results[0] is None:
        return []
    return [x for r in results for x in r]


class Method:
    STORE = 0       # raw bytes
    ZERO = 1        # all-zero chunk: zero-length payload (paper: truncated)
    HUFF = 2        # ZipNN canonical Huffman, shared per-plane table
    ZLIB = 3        # LZ77+Huffman (zlib) — delta / embedding-layer path
    HUFFLIB = 4     # zlib Z_HUFFMAN_ONLY — C-speed Huffman-only backend

    NAMES = {0: "store", 1: "zero", 2: "huff", 3: "zlib", 4: "hufflib"}


@dataclasses.dataclass
class ChunkEntry:
    """Metadata-map record for one (chunk, plane) payload."""

    method: int
    comp_len: int
    raw_len: int
    crc: int


@dataclasses.dataclass
class CodecParams:
    """Tunables for the plane codec (paper defaults)."""

    chunk_bytes: int = 1 << 17          # per-plane chunk (128 KiB, BF16 default)
    incompressible: float = 0.98        # probe threshold: est ratio ⇒ STORE
    skip_chunks: int = 8                # probe-skip run length after a STORE
    delta_mode: bool = False            # enable §4.2 zeros/zero-run criteria
    zeros_frac_zlib: float = 0.90       # zeros fraction ⇒ prefer LZ
    zero_run_frac_zlib: float = 0.03    # longest zero-run fraction ⇒ prefer LZ
    backend: str = "huffman"            # 'huffman' (ours) | 'hufflib' (zlib -2)
    zlib_level: int = 6


def hist256(a: np.ndarray) -> np.ndarray:
    """Byte histogram, chunked.

    ``np.bincount`` casts its input to intp; above ~2^22 elements the temp
    buffer exceeds the allocator cache and per-call page faults make it ~5×
    slower per byte.  Summing sub-2^21 pieces keeps every temp cached.
    """
    if a.size <= (1 << 21):
        return np.bincount(a, minlength=256)
    if not a.flags.c_contiguous or a.size % 2:
        h = np.zeros(256, dtype=np.int64)
        for i in range(0, a.size, 1 << 21):
            h += np.bincount(a[i : i + (1 << 21)], minlength=256)
        return h
    # Count byte *pairs* as uint16 and fold the 256×256 table: skewed model
    # bytes hammer a handful of counters, and pairing halves the
    # store-to-load dependency chains on those hot counters (~2×).
    h = np.zeros(256, dtype=np.int64)
    u16 = a.view(np.uint16)
    for i in range(0, u16.size, 1 << 20):
        c16 = np.bincount(u16[i : i + (1 << 20)], minlength=65536).reshape(256, 256)
        h += c16.sum(axis=0, dtype=np.int64)
        h += c16.sum(axis=1, dtype=np.int64)
    return h


def table_probe_hist(plane: np.ndarray) -> np.ndarray:
    """Smoothed whole-plane histogram used for the Huffman table and the
    §3.1 plane-level probes.

    Built from a strided sample (≤ 4 MiB) with +1 smoothing on large planes
    so every byte value keeps a code; ratio impact is < 0.1 % and the probe
    cost drops ~10× on large planes.  One implementation shared by the host
    path and the device plane-producer backend — the table (and therefore
    every output byte) is identical no matter which backend probed.
    """
    n = plane.size
    if n > (1 << 22):
        stride = n // (1 << 22)
        return hist256(plane[::stride]) * stride + 1
    return hist256(plane) + (1 if n else 0)


@dataclasses.dataclass
class ProbeStats:
    """Externally supplied probe statistics for one plane.

    Produced by the device plane-producer backend (``core.device_plane``):
    the per-chunk histograms come straight off a device histogram pass, so
    :meth:`PlaneCodec.plan` consumes them without running ``hist256`` /
    ``np.bincount`` at all — the GIL-bound probe disappears from the host
    schedule.  Counts are exact, so the chosen methods (and the output
    bytes) are identical to the host probe's.
    """

    chunk_hists: np.ndarray            # (n_chunks, 256) exact per-chunk counts
    table_hist: np.ndarray             # == table_probe_hist(plane)

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_hists.shape[0])


def longest_zero_run(chunk: np.ndarray) -> int:
    """Length of the longest run of zero bytes (vectorized)."""
    nz = np.flatnonzero(chunk)
    if nz.size == 0:
        return int(chunk.size)
    gaps = np.diff(nz) - 1
    head = int(nz[0])
    tail = int(chunk.size - nz[-1] - 1)
    best = max(head, tail)
    if gaps.size:
        best = max(best, int(gaps.max()))
    return best


def _huffman_only_zlib(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    return co.compress(data) + co.flush()


def _zlib(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def _unzlib(data: bytes, raw_len: int) -> bytes:
    try:
        return zlib.decompress(data, -15, raw_len)
    except zlib.error as e:
        raise IOError(f"corrupt zlib chunk payload: {e}") from None


@dataclasses.dataclass
class PlaneCodec:
    """Compresses one byte-group plane into chunk payloads + metadata map."""

    params: CodecParams
    table: Optional[np.ndarray] = None          # shared canonical lengths
    codes: Optional[np.ndarray] = None

    def build_table(self, plane: np.ndarray) -> None:
        hist = hist256(plane)
        self.table = huffman.code_lengths(hist)
        self.codes = huffman.canonical_codes(self.table)

    def table_blob(self) -> bytes:
        if self.table is None:
            raise RuntimeError("table_blob() called before build_table()")
        return huffman.pack_table(self.table)

    # -- compression ------------------------------------------------------
    #
    # compress() is split into three per-chunk work-item stages so the
    # serial path, the thread-pool path (engine.py), and the streaming file
    # path share ONE implementation:
    #
    #   plan()        pass 1 — per-chunk method selection (sequential: the
    #                 probe-skip state machine carries state across chunks);
    #   encode_ids()  pass 2 — pure batch encoder over an arbitrary subset
    #                 of chunk ids.  Chunk payloads are byte-aligned and
    #                 independent, so any partition of the id space produces
    #                 byte-identical blobs — the invariant that makes the
    #                 pool path deterministic;
    #   finalize()    pass 3 — expansion fallback + metadata map.

    def plan(self, plane: np.ndarray, pool=None, probe: Optional[ProbeStats] = None) -> List[int]:
        """Pass 1: choose a method per chunk (probe + probe-skip logic).

        The per-chunk probe *statistics* (histogram → estimated size, zero
        run) are pure per-chunk work items and fan out across ``pool``; the
        probe-skip state machine that consumes them stays sequential, so the
        chosen methods are identical for any thread count.

        When ``probe`` is supplied (the device plane-producer backend
        already histogrammed every chunk on-accelerator), no histogram is
        computed here at all — the whole pass 1 is a cheap host-side walk
        over precomputed counts, and the chosen methods are identical
        because the counts are exact.
        """
        p = self.params
        n = plane.size
        n_chunks = -(-n // p.chunk_bytes) if n else 0

        # Whole-plane fast path (§3.1): regular-model fraction planes are
        # incompressible — detect once, store raw, skip all per-chunk work.
        # See table_probe_hist() for the sampled-histogram rationale.
        hist = probe.table_hist if probe is not None else table_probe_hist(plane)
        if self.table is None:
            self.table = huffman.code_lengths(hist)
            self.codes = huffman.canonical_codes(self.table)
        hist_mass = max(int(hist.sum()), 1)
        est_plane = huffman.estimate_encoded_bits(hist, self.table) / 8.0
        if probe is not None:
            if probe.n_chunks != n_chunks:
                raise ValueError(
                    f"probe has {probe.n_chunks} chunk histograms, plane has "
                    f"{n_chunks} chunks"
                )
            plane_zero = n > 0 and int(probe.chunk_hists[:, 0].sum()) == n
        else:
            plane_zero = n > 0 and not plane.any()
        plane_incompressible = (
            not p.delta_mode and n > 0 and est_plane / hist_mass >= p.incompressible
        )
        if plane_zero:
            return [Method.ZERO] * n_chunks
        if plane_incompressible:
            return [Method.STORE] * n_chunks

        if probe is not None:
            stats = self._stats_from_probe(plane, probe)
        else:
            stats = _fan_out(
                pool, n_chunks, lambda ids: self._chunk_stats(plane, ids)
            )

        methods: List[int] = []
        skip = 0
        for c in range(n_chunks):
            m = self._method_from_stats(*stats[c], skip)
            if m == Method.STORE and skip == 0:
                skip = p.skip_chunks          # probe fired: skip next chunks
            elif skip > 0:
                skip -= 1
            methods.append(m)
        return methods

    def _chunk_stats(
        self, plane: np.ndarray, ids: Sequence[int]
    ) -> List[Tuple[int, int, int, int]]:
        """Probe work item: (n, zeros, est_bytes, zero_run) per chunk id."""
        p = self.params
        out = []
        for c in ids:
            chunk = plane[c * p.chunk_bytes : (c + 1) * p.chunk_bytes]
            hist = np.bincount(chunk, minlength=256)
            zeros = int(hist[0])
            est = huffman.estimate_encoded_bits(hist, self.table) / 8.0
            zrun = (
                longest_zero_run(chunk)
                if p.delta_mode and 0 < zeros < chunk.size
                else zeros
            )
            out.append((chunk.size, zeros, est, zrun))
        return out

    def _stats_from_probe(
        self, plane: np.ndarray, probe: ProbeStats
    ) -> List[Tuple[int, int, float, int]]:
        """Per-chunk (n, zeros, est_bytes, zero_run) from device histograms.

        Mirrors :meth:`_chunk_stats` exactly, except the counts come from
        ``probe.chunk_hists`` instead of ``np.bincount``.  The zero-run
        statistic (needed only for §4.2 delta chunks that are neither all-
        nor mostly-zero) is not derivable from a histogram, so those chunks
        fall back to the vectorized host scan — same values, same methods.
        """
        p = self.params
        n = plane.size
        out: List[Tuple[int, int, float, int]] = []
        for c in range(probe.n_chunks):
            hist = probe.chunk_hists[c]
            size = min(p.chunk_bytes, n - c * p.chunk_bytes)
            zeros = int(hist[0])
            est = huffman.estimate_encoded_bits(hist, self.table) / 8.0
            zrun = (
                longest_zero_run(plane[c * p.chunk_bytes : (c + 1) * p.chunk_bytes])
                if p.delta_mode and 0 < zeros < size
                else zeros
            )
            out.append((size, zeros, est, zrun))
        return out

    def _method_from_stats(
        self, n: int, zeros: int, est: float, zrun: int, skip: int
    ) -> int:
        """§3.2/§4.2 method selection from precomputed probe statistics."""
        p = self.params
        if zeros == n:
            return Method.ZERO
        if p.delta_mode:
            # §4.2 auto-detection: zeros fraction / longest zero run ⇒ LZ.
            if zeros >= p.zeros_frac_zlib * n:
                return Method.ZLIB
            if zrun >= p.zero_run_frac_zlib * n:
                return Method.ZLIB
        if skip > 0:
            return Method.STORE               # inside a probe-skip run
        if est / n >= p.incompressible:
            return Method.STORE
        return Method.HUFF if p.backend == "huffman" else Method.HUFFLIB

    def encode_ids(
        self, plane: np.ndarray, methods: Sequence[int], ids: Sequence[int]
    ) -> List[bytes]:
        """Pass 2 work item: encode the given chunk ids, in ``ids`` order.

        Pure w.r.t. shared state (the table is read-only), so any number of
        these can run concurrently.  All HUFF chunks of the batch go through
        one vectorized :func:`huffman.encode_chunks` call.
        """
        cb = self.params.chunk_bytes
        huff_blobs = {}
        huff_ids = [c for c in ids if methods[c] == Method.HUFF]
        if huff_ids:
            segs = [plane[c * cb : (c + 1) * cb] for c in huff_ids]
            blobs = huffman.encode_chunks(
                np.concatenate(segs),
                np.asarray([s.size for s in segs]),
                self.table,
                self.codes,
            )
            huff_blobs = dict(zip(huff_ids, blobs))
        out: List[bytes] = []
        for c in ids:
            m = methods[c]
            if m == Method.HUFF:
                out.append(huff_blobs[c])
            elif m == Method.ZERO:
                out.append(b"")
            else:
                out.append(self._encode(plane[c * cb : (c + 1) * cb], m))
        return out

    def finalize(
        self, plane: np.ndarray, methods: List[int], payloads: List[bytes]
    ) -> List[ChunkEntry]:
        """Pass 3: metadata map (+ raw fallback for expansion).

        Mutates ``payloads`` in place where a chunk expanded.
        """
        p = self.params
        n = plane.size
        entries: List[ChunkEntry] = []
        for c in range(len(methods)):
            raw_len = min(p.chunk_bytes, n - c * p.chunk_bytes)
            m, blob = methods[c], payloads[c]
            if m not in (Method.ZERO, Method.STORE) and len(blob) >= raw_len:
                chunk = plane[c * p.chunk_bytes : (c + 1) * p.chunk_bytes]
                m, blob = Method.STORE, chunk.tobytes()
                payloads[c] = blob
            entries.append(
                ChunkEntry(m, len(blob), raw_len, 0 if m == Method.ZERO else zlib.crc32(blob))
            )
        return entries

    def compress(
        self, plane: np.ndarray, pool=None, probe: Optional[ProbeStats] = None
    ) -> Tuple[List[ChunkEntry], List[bytes]]:
        """Compress one plane; ``pool`` (a ThreadPoolExecutor) fans the
        encode work items across threads with deterministic ordering.
        ``probe`` injects device-computed probe statistics (see
        :class:`ProbeStats`) — bytes out are identical either way."""
        methods = self.plan(plane, pool=pool, probe=probe)
        payloads = _fan_out(
            pool, len(methods), lambda ids: self.encode_ids(plane, methods, ids)
        )
        entries = self.finalize(plane, methods, payloads)
        return entries, payloads

    def _choose_method(self, chunk: np.ndarray, skip: int) -> int:
        """Single-chunk probe (stats + selection in one call)."""
        hist = np.bincount(chunk, minlength=256)
        zeros = int(hist[0])
        est = huffman.estimate_encoded_bits(hist, self.table) / 8.0
        zrun = (
            longest_zero_run(chunk)
            if self.params.delta_mode and 0 < zeros < chunk.size
            else zeros
        )
        return self._method_from_stats(chunk.size, zeros, est, zrun, skip)

    def _encode(self, chunk: np.ndarray, method: int) -> bytes:
        if method == Method.ZERO:
            return b""
        if method == Method.STORE:
            return chunk.tobytes()
        if method == Method.HUFF:
            return huffman.encode(chunk, self.table, self.codes)
        if method == Method.ZLIB:
            return _zlib(chunk.tobytes(), self.params.zlib_level)
        if method == Method.HUFFLIB:
            return _huffman_only_zlib(chunk.tobytes(), self.params.zlib_level)
        raise ValueError(f"unknown method {method}")

    # -- decompression ----------------------------------------------------

    def decode_into(
        self,
        out: np.ndarray,
        offs: np.ndarray,
        entries: Sequence[ChunkEntry],
        payloads: Sequence[bytes],
        ids: Sequence[int],
    ) -> None:
        """Decode work item: rebuild the given chunk ids into ``out``.

        Each id writes a disjoint slice of ``out`` so work items are safe to
        run concurrently.  HUFF chunks of a batch decode in lockstep
        (chunk-parallel) through one :func:`huffman.decode_many` call.

        Every payload's CRC (recorded in the metadata map at encode time) is
        verified *before* its bytes reach a decoder, so a flipped payload
        byte raises a clean ``IOError`` instead of feeding garbage to the
        entropy stage — the corruption-fuzz contract.  Verification is part
        of the work item, so it parallelizes with the decode itself.
        """
        for i in ids:
            e = entries[i]
            if e.method == Method.ZERO:
                if e.comp_len or e.crc:
                    raise IOError(
                        "corrupt chunk entry: ZERO chunk with a payload"
                    )
            elif zlib.crc32(payloads[i]) != e.crc:
                raise IOError(f"chunk payload CRC mismatch (chunk {i})")
        huff_idx = [i for i in ids if entries[i].method == Method.HUFF]
        if huff_idx:
            if self.table is None:
                raise IOError("corrupt stream: HUFF chunks but no plane table")
            if any(not payloads[i] and entries[i].raw_len for i in huff_idx):
                raise IOError("corrupt chunk entry: empty HUFF payload")
            decoded = huffman.decode_many(
                [payloads[i] for i in huff_idx],
                [entries[i].raw_len for i in huff_idx],
                self.table,
            )
            for i, d in zip(huff_idx, decoded):
                out[offs[i] : offs[i + 1]] = d

        for i in ids:
            e = entries[i]
            if e.method == Method.HUFF:
                continue
            dst = out[offs[i] : offs[i + 1]]
            if e.method == Method.ZERO:
                dst[:] = 0
            elif e.method == Method.STORE:
                if e.comp_len != e.raw_len:
                    raise IOError(
                        "corrupt chunk entry: STORE length != raw length"
                    )
                dst[:] = np.frombuffer(payloads[i], dtype=np.uint8)
            elif e.method in (Method.ZLIB, Method.HUFFLIB):
                blob = _unzlib(payloads[i], e.raw_len)
                if len(blob) != e.raw_len:
                    raise IOError(
                        "corrupt zlib chunk payload: wrong decoded length"
                    )
                dst[:] = np.frombuffer(blob, dtype=np.uint8)
            else:
                raise ValueError(f"unknown method {e.method}")

    def decompress(
        self, entries: Sequence[ChunkEntry], payloads: Sequence[bytes], pool=None
    ) -> np.ndarray:
        """Rebuild a plane, optionally fanning chunk decodes across a pool."""
        total = sum(e.raw_len for e in entries)
        out = np.empty(total, dtype=np.uint8)
        offs = np.concatenate(
            [[0], np.cumsum([e.raw_len for e in entries])]
        ).astype(np.int64)

        _fan_out(
            pool,
            len(entries),
            lambda ids: self.decode_into(out, offs, entries, payloads, ids),
        )
        return out


def compress_plane(
    plane: np.ndarray,
    params: CodecParams,
    pool=None,
    probe: Optional[ProbeStats] = None,
) -> Tuple[List[ChunkEntry], List[bytes], Optional[bytes]]:
    """One-shot plane compression. Returns (entries, payloads, table_blob).

    ``plane`` may come from anywhere — the host byte-split
    (:func:`.bitlayout.to_planes`) or a device plane producer; with
    ``probe`` supplied the probe pass consumes precomputed statistics
    instead of histogramming.
    """
    codec = PlaneCodec(params)
    entries, payloads = codec.compress(plane, pool=pool, probe=probe)
    needs_table = any(e.method == Method.HUFF for e in entries)
    return entries, payloads, (codec.table_blob() if needs_table else None)


def decompress_plane(
    entries: Sequence[ChunkEntry],
    payloads: Sequence[bytes],
    table_blob: Optional[bytes],
    params: CodecParams,
    pool=None,
) -> np.ndarray:
    codec = PlaneCodec(params)
    if table_blob is not None:
        codec.table = huffman.unpack_table(table_blob)
    return codec.decompress(entries, payloads, pool=pool)
