"""Binary container (.znn) for one compressed byte stream / tensor.

Layout (little-endian)::

    magic       4s   b'ZNN1'
    version     u16
    flags       u16  bit0: planes-mode, bit1: delta stream
    layout      16s  bit-layout name (padded)
    n_bytes     u64  raw byte length
    chunk_bytes u32  per-plane chunk size
    n_planes    u8
    pad         3x
    -- per plane --
    has_table   u8   (+ 128-byte nibble table when set)
    -- metadata map (n_chunks × n_planes records, chunk-major) --
    method      u8
    comp_len    u32
    crc         u32
    -- payloads, same order, byte-aligned --

The metadata map is the paper's §5.1 "map for the whole model containing
metadata for each byte-group and each chunk": every payload's offset is
computable up front, so any (chunk, plane) can be decompressed independently
and in parallel.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

from .codec import ChunkEntry

__all__ = ["pack_stream", "unpack_stream", "StreamMeta"]

_MAGIC = b"ZNN1"
_HDR = struct.Struct("<4sHH16sQIB3x")
_REC = struct.Struct("<BII")

FLAG_PLANES = 1
FLAG_DELTA = 2


class StreamMeta:
    """Parsed header + metadata map of a .znn stream."""

    def __init__(
        self,
        layout_name: str,
        n_bytes: int,
        chunk_bytes: int,
        flags: int,
        tables: List[Optional[bytes]],
        entries: List[List[ChunkEntry]],
        payload_offsets: List[List[int]],
        payload_base: int,
    ):
        self.layout_name = layout_name
        self.n_bytes = n_bytes
        self.chunk_bytes = chunk_bytes
        self.flags = flags
        self.tables = tables
        self.entries = entries               # [plane][chunk]
        self.payload_offsets = payload_offsets
        self.payload_base = payload_base

    @property
    def n_planes(self) -> int:
        return len(self.entries)

    @property
    def is_delta(self) -> bool:
        return bool(self.flags & FLAG_DELTA)


def pack_stream(
    layout_name: str,
    n_bytes: int,
    chunk_bytes: int,
    plane_tables: Sequence[Optional[bytes]],
    plane_entries: Sequence[Sequence[ChunkEntry]],
    plane_payloads: Sequence[Sequence[bytes]],
    *,
    delta: bool = False,
) -> bytes:
    """Serialize compressed planes into one blob."""
    n_planes = len(plane_entries)
    flags = FLAG_PLANES | (FLAG_DELTA if delta else 0)
    parts: List[bytes] = [
        _HDR.pack(
            _MAGIC,
            1,
            flags,
            layout_name.encode().ljust(16, b"\x00"),
            n_bytes,
            chunk_bytes,
            n_planes,
        )
    ]
    for t in plane_tables:
        if t is None:
            parts.append(b"\x00")
        else:
            if len(t) != 128:
                raise ValueError(
                    f"plane table must be 128 packed bytes, got {len(t)}"
                )
            parts.append(b"\x01" + t)
    # Metadata map, chunk-major so a prefix read yields a prefix of chunks.
    n_chunks = len(plane_entries[0]) if n_planes else 0
    for c in range(n_chunks):
        for p in range(n_planes):
            e = plane_entries[p][c]
            parts.append(_REC.pack(e.method, e.comp_len, e.crc))
    for c in range(n_chunks):
        for p in range(n_planes):
            parts.append(plane_payloads[p][c])
    return b"".join(parts)


def unpack_stream(blob: bytes) -> Tuple[StreamMeta, memoryview]:
    """Parse header + metadata map; payloads stay as a zero-copy memoryview.

    Corrupt or truncated input raises ``ValueError`` — every size that
    drives a parse loop is bounds-checked against the blob before the loop
    runs, so a flipped header byte can never turn into an unbounded
    allocation, a hang, or a struct error escaping as something unclean.
    """
    mv = memoryview(blob)
    try:
        magic, version, flags, layout_b, n_bytes, chunk_bytes, n_planes = (
            _HDR.unpack_from(mv, 0)
        )
    except struct.error:
        raise ValueError("truncated ZNN1 header") from None
    if magic != _MAGIC:
        raise ValueError("not a ZNN1 stream")
    if version != 1:
        raise ValueError(f"unsupported ZNN version {version}")
    if chunk_bytes <= 0:
        raise ValueError("corrupt ZNN1 header: chunk_bytes must be positive")
    off = _HDR.size
    try:
        layout_name = layout_b.rstrip(b"\x00").decode()
    except UnicodeDecodeError:
        raise ValueError("corrupt ZNN1 header: bad layout name") from None

    tables: List[Optional[bytes]] = []
    for _ in range(n_planes):
        if off >= len(mv):
            raise ValueError("truncated ZNN1 plane-table section")
        has = mv[off]
        off += 1
        if has:
            if off + 128 > len(mv):
                raise ValueError("truncated ZNN1 plane table")
            tables.append(bytes(mv[off : off + 128]))
            off += 128
        else:
            tables.append(None)

    plane_bytes = -(-n_bytes // (chunk_bytes * n_planes)) if n_planes else 0
    n_per_plane = n_bytes // n_planes if n_planes else 0
    n_chunks = -(-n_per_plane // chunk_bytes) if n_per_plane else 0

    if off + n_chunks * n_planes * _REC.size > len(mv):
        raise ValueError("truncated ZNN1 metadata map")
    entries: List[List[ChunkEntry]] = [[] for _ in range(n_planes)]
    for c in range(n_chunks):
        for p in range(n_planes):
            method, comp_len, crc = _REC.unpack_from(mv, off)
            off += _REC.size
            raw = min(chunk_bytes, n_per_plane - c * chunk_bytes)
            entries[p].append(ChunkEntry(method, comp_len, raw, crc))

    payload_offsets: List[List[int]] = [[0] * n_chunks for _ in range(n_planes)]
    cursor = off
    for c in range(n_chunks):
        for p in range(n_planes):
            payload_offsets[p][c] = cursor
            cursor += entries[p][c].comp_len

    del plane_bytes  # (derivable; kept for clarity of the format doc)
    meta = StreamMeta(
        layout_name, n_bytes, chunk_bytes, flags, tables, entries, payload_offsets, off
    )
    return meta, mv


def payload_view(meta: StreamMeta, mv: memoryview, plane: int, chunk: int) -> bytes:
    e = meta.entries[plane][chunk]
    o = meta.payload_offsets[plane][chunk]
    return bytes(mv[o : o + e.comp_len])
