"""Chunk scheduler and the ZNS1 streaming file engine.

**Chunk scheduler** — a process-wide cache of thread pools
(:func:`get_pool`).  Every (plane, chunk) work item of the codec is
independent, and payloads are byte-aligned per chunk, so fanning them
across a pool changes wall-clock only: output bytes are identical for any
thread count.

**Streaming file API** — :func:`compress_file` / :func:`decompress_file`
and the underlying :class:`CompressWriter` / :class:`DecompressReader`
process one window (default 64 MiB) at a time and append framed ``ZNN1``
segments to a ``ZNS1`` container, so a file of any size round-trips with
peak extra memory O(window):

    magic    4s   b'ZNS1'
    version  u16
    flags    u16  (reserved)
    dtype    16s  dtype name (padded)
    window   u64  window bytes used at write time
    -- frames, repeated --
    kind     u8   1 = data frame, 0 = end-of-stream
    raw_len  u64  uncompressed bytes in this frame (total stream len on end)
    comp_len u64  compressed bytes following (0 on end)
    crc      u32  crc32 of the compressed frame body
    body     comp_len bytes — one self-contained ZNN1 stream

Every frame is an independent ``ZNN1`` blob from
:func:`.zipnn.compress_bytes`, so the unaligned remainder of the stream
rides the last frame's ``TAIL``.  The bytes equal the reference
implementation's ``repro.core.engine`` files for the same stream, config
and window.

**Frame pipelining** — with ``threads > 1`` up to ``pipeline_depth``
windows compress at once on dedicated pipeline threads while the caller
reads the next one, and the reader decodes frame k while the bytes of
later frames are read and CRC-checked.  Frames are written and yielded
strictly in order, so pipelining never changes the file or the stream.

**Where frames run** — ``options`` (a :class:`.options.CodecOptions`)
and ``device=`` (default ``"cuda"``) go to :func:`.zipnn.compress_bytes`
and :func:`.zipnn.decompress_bytes` unchanged: ``backend="device"`` plans
each window with K3 and bit-packs it with K7 on ``device``; decode on the
card runs K1 (HUFF chunks) and K2 (un-plane) there.  Under the default
``"auto"`` a frame is host bytes, so it encodes and decodes on the card
whenever ``device`` is a card that is present, and on the host otherwise
(:func:`.options.resolve_backend`).  Bytes are identical for every
``threads`` × ``pipeline_depth`` × backend.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import IO, Any, Dict, Iterator, Optional, Tuple, Union

from . import bitlayout
from .options import CodecOptions, resolve_options

__all__ = [
    "DEFAULT_WINDOW",
    "resolve_threads",
    "get_pool",
    "CompressWriter",
    "DecompressReader",
    "compress_file",
    "decompress_file",
    "frame_records",
]

DEFAULT_WINDOW = 64 << 20          # 64 MiB streaming window

_STREAM_MAGIC = b"ZNS1"
_SHDR = struct.Struct("<4sHH16sQ")          # magic, version, flags, dtype, window
_FRAME = struct.Struct("<BQQI")             # kind, raw_len, comp_len, crc
_KIND_DATA = 1
_KIND_END = 0

# Frame bodies are read through _read_exact in pieces of at most this many
# bytes: a corrupt u64 comp_len field must never drive a single giant
# allocation before the truncation check can reject it.
_READ_CHUNK = 8 << 20


def _read_exact(fp: IO[bytes], n: int) -> bytes:
    """Read up to ``n`` bytes, allocating at most ``_READ_CHUNK`` at a time.

    Returns fewer than ``n`` bytes only at EOF, like one ``read(n)`` on a
    regular file: callers keep their ``len(...) < n`` truncation checks,
    and a flipped length byte fails on the first short piece.
    """
    if n <= _READ_CHUNK:
        return fp.read(n)
    parts = []
    remaining = n
    while remaining > 0:
        piece = fp.read(min(remaining, _READ_CHUNK))
        if not piece:
            break
        parts.append(piece)
        remaining -= len(piece)
    return b"".join(parts)


# ---------------------------------------------------------------------------
# chunk scheduler: shared thread pools
# ---------------------------------------------------------------------------

def resolve_threads(threads: Optional[int]) -> int:
    """Normalize the ``threads`` knob: 0/1/None → serial, -1 → all cores.

    Requests beyond the core count are capped: the work items are CPU-bound
    (zlib/numpy), so extra workers only add context-switch and GIL churn.
    """
    if threads is None or threads == 0 or threads == 1:
        return 1
    cores = os.cpu_count() or 1
    if threads < 0:
        return cores
    return min(threads, cores)


_pools: Dict[int, ThreadPoolExecutor] = {}
_pools_lock = threading.Lock()


def get_pool(threads: Optional[int]) -> Optional[ThreadPoolExecutor]:
    """Shared executor for ``threads`` workers, or None for the serial path.

    Pools are cached per worker count for the life of the process: codec
    calls are frequent (every tensor of a pytree) and executor start-up is
    not free.  Idle pooled threads cost nothing while blocked on the queue.
    """
    n = resolve_threads(threads)
    if n <= 1:
        return None
    with _pools_lock:
        pool = _pools.get(n)
        if pool is None:
            pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix=f"zipnn-{n}"
            )
            _pools[n] = pool
        return pool


# ---------------------------------------------------------------------------
# streaming file API
# ---------------------------------------------------------------------------

PathOrFile = Union[str, os.PathLike, IO[bytes]]


def _open(fp: PathOrFile, mode: str) -> Tuple[IO[bytes], bool]:
    if isinstance(fp, (str, os.PathLike)):
        return open(fp, mode), True
    return fp, False


def _frame_options(config, opts: CodecOptions) -> CodecOptions:
    """The options every frame of one stream runs with: the stream's
    ``threads`` (the config's when unset) and its backends."""
    threads = config.threads if opts.threads is None else opts.threads
    return CodecOptions(
        threads=threads, backend=opts.backend, entropy_backend=opts.entropy_backend
    )


class CompressWriter:
    """Bounded-memory streaming compressor (file-like ``write``).

    Buffers raw bytes until a full window is available, compresses the
    window with :func:`.zipnn.compress_bytes` and appends one frame.  Peak
    memory is a small multiple of the window, independent of the stream's
    length.  Windows are aligned down to the layout's plane-split granule
    (the itemsize; 2 for the fp8 nibble planes) so only the final frame can
    carry an unaligned ``TAIL`` remainder.

    With ``threads > 1`` up to ``pipeline_depth`` windows compress at once
    on dedicated pipeline threads (not on the engine pool, so a writer can
    never deadlock the pool its own chunk work items need); frames are
    written strictly in submission order.  A failed frame aborts the
    stream: no end frame is written, so readers reject it.
    """

    def __init__(
        self,
        fp: PathOrFile,
        dtype_name: str,
        config=None,
        *,
        window_bytes: int = DEFAULT_WINDOW,
        threads: Optional[int] = None,
        backend: Optional[str] = None,
        entropy_backend: Optional[str] = None,
        options: Optional[CodecOptions] = None,
        pipeline_depth: int = 2,
        device: Any = "cuda",
    ):
        from . import zipnn   # lazy: zipnn imports this module

        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self._config = zipnn.DEFAULT if config is None else config
        opts = resolve_options(
            options, threads=threads, backend=backend, entropy_backend=entropy_backend
        )
        self._opts = _frame_options(self._config, opts)
        self._device = device
        self._dtype_name = dtype_name
        align = bitlayout.layout_for(dtype_name).align
        self._window = max(window_bytes - window_bytes % align, align)
        self._buf = bytearray()
        self._fp, self._own = _open(fp, "wb")
        self._closed = False
        self._depth = pipeline_depth
        self._pipe: Optional[ThreadPoolExecutor] = None
        self._pending: deque = deque()  # (raw_len, Future[bytes]) in flight
        self.raw_bytes = 0
        self.comp_bytes = 0
        hdr = _SHDR.pack(
            _STREAM_MAGIC, 1, 0, dtype_name.encode().ljust(16, b"\x00"), self._window
        )
        self._fp.write(hdr)
        self.comp_bytes += len(hdr)

    @property
    def window(self) -> int:
        """Raw bytes per frame (the window aligned to the layout)."""
        return self._window

    def write(self, data: bytes) -> int:
        self._buf += data
        while len(self._buf) >= self._window:
            self._submit(bytes(self._buf[: self._window]))
            del self._buf[: self._window]
        return len(data)

    def _compress(self, raw: bytes) -> bytes:
        from . import zipnn

        return zipnn.compress_bytes(
            raw, self._dtype_name, self._config, options=self._opts, device=self._device
        )

    def _submit(self, raw: bytes) -> None:
        """Compress one window — pipelined when the engine is threaded."""
        if resolve_threads(self._opts.threads) <= 1:
            self._write_frame(len(raw), self._compress(raw))
            return
        while len(self._pending) >= self._depth:
            raw_len, fut = self._pending.popleft()
            self._write_frame(raw_len, fut.result())
        if self._pipe is None:
            self._pipe = ThreadPoolExecutor(
                max_workers=self._depth, thread_name_prefix="zipnn-frame-pipe"
            )
        self._pending.append((len(raw), self._pipe.submit(self._compress, raw)))

    def _drain(self) -> None:
        """Write every in-flight frame, in submission order."""
        while self._pending:
            raw_len, fut = self._pending.popleft()
            self._write_frame(raw_len, fut.result())

    def _write_frame(self, raw_len: int, blob: bytes) -> None:
        self._fp.write(_FRAME.pack(_KIND_DATA, raw_len, len(blob), zlib.crc32(blob)))
        self._fp.write(blob)
        self.raw_bytes += raw_len
        self.comp_bytes += _FRAME.size + len(blob)

    def close(self) -> None:
        if self._closed:
            return
        try:
            self._drain()
            if self._buf:
                self._write_frame(len(self._buf), self._compress(bytes(self._buf)))
                self._buf.clear()
            self._fp.write(_FRAME.pack(_KIND_END, self.raw_bytes, 0, 0))
            self.comp_bytes += _FRAME.size
            self._fp.flush()
        except BaseException:
            # A failed frame leaks no file or pipeline thread and leaves the
            # stream without an end frame, so readers reject it.
            self.abort()
            raise
        if self._pipe is not None:
            self._pipe.shutdown(wait=True)
            self._pipe = None
        if self._own:
            self._fp.close()
        self._closed = True

    def abort(self) -> None:
        """Close without finalizing: no buffered flush, no end frame.  The
        file then fails :class:`DecompressReader`'s end-frame check, so an
        interrupted write never reads as a complete stream."""
        if self._closed:
            return
        while self._pending:
            _, fut = self._pending.popleft()
            fut.cancel()
            try:
                fut.result()            # wait out a frame already running
            except BaseException:
                pass                    # discarded either way
        if self._pipe is not None:
            self._pipe.shutdown(wait=True)
            self._pipe = None
        self._buf.clear()
        if self._own:
            self._fp.close()
        self._closed = True

    def __enter__(self) -> "CompressWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


class DecompressReader:
    """Streaming decompressor over a ``ZNS1`` container.

    :meth:`frames` and :meth:`read` hold one decompressed window at a time.
    Frame CRCs are checked before decode, each frame's length after it, and
    the total against the end frame; a stream without an end frame raises
    ``IOError``.  With ``threads > 1`` up to ``pipeline_depth`` frames
    decode at once on pipeline threads while later frames are read and
    CRC-checked; frames resolve strictly in stream order.
    """

    def __init__(
        self,
        fp: PathOrFile,
        config=None,
        *,
        threads: Optional[int] = None,
        backend: Optional[str] = None,
        entropy_backend: Optional[str] = None,
        options: Optional[CodecOptions] = None,
        pipeline_depth: int = 2,
        device: Any = "cuda",
    ):
        from . import zipnn

        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self._config = zipnn.DEFAULT if config is None else config
        opts = resolve_options(
            options, threads=threads, backend=backend, entropy_backend=entropy_backend
        )
        self._opts = _frame_options(self._config, opts)
        self._device = device
        self._depth = pipeline_depth
        self._fp, self._own = _open(fp, "rb")
        hdr = self._fp.read(_SHDR.size)
        if len(hdr) < _SHDR.size:
            raise ValueError("truncated ZNS1 header")
        magic, version, _flags, dtype_b, window = _SHDR.unpack(hdr)
        if magic != _STREAM_MAGIC:
            raise ValueError("not a ZNS1 stream")
        if version != 1:
            raise ValueError(f"unsupported ZNS version {version}")
        self.dtype_name = dtype_b.rstrip(b"\x00").decode()
        self.window = window
        self._pending = b""
        self._frames = self._frame_iter()
        self._exhausted = False

    def _decode(self, blob: bytes) -> bytes:
        from . import zipnn

        return zipnn.decompress_bytes(
            blob, self._config, options=self._opts, device=self._device
        )

    def _frame_iter(self) -> Iterator[bytes]:
        """The one generator over the file's frames: :meth:`read` and
        :meth:`frames` both draw from it, so mixing them skips nothing."""
        use_pipe = resolve_threads(self._opts.threads) > 1
        pipe: Optional[ThreadPoolExecutor] = None
        total = 0
        pending: deque = deque()        # (future-or-blob, declared raw_len)

        def resolve(p) -> bytes:
            nonlocal total
            item, raw_len = p
            raw = item.result() if hasattr(item, "result") else self._decode(item)
            if len(raw) != raw_len:
                raise IOError(f"frame decoded to {len(raw)} bytes, expected {raw_len}")
            total += raw_len
            return raw

        try:
            while True:
                rec = self._fp.read(_FRAME.size)
                if len(rec) < _FRAME.size:
                    raise IOError("truncated ZNS1 stream (missing end frame)")
                kind, raw_len, comp_len, crc = _FRAME.unpack(rec)
                if kind not in (_KIND_DATA, _KIND_END):
                    raise IOError(f"corrupt ZNS1 frame kind {kind}")
                if kind == _KIND_END:
                    last = [resolve(p) for p in pending]
                    pending.clear()
                    # the end frame records the total raw length: a stream
                    # with whole frames missing must not parse as complete
                    if total != raw_len:
                        raise IOError(
                            f"ZNS1 stream yielded {total} bytes, end frame "
                            f"declares {raw_len}"
                        )
                    yield from last
                    return
                blob = _read_exact(self._fp, comp_len)
                if len(blob) < comp_len:
                    raise IOError("truncated ZNS1 frame body")
                if zlib.crc32(blob) != crc:
                    raise IOError("ZNS1 frame CRC mismatch")
                if use_pipe and pipe is None:
                    pipe = ThreadPoolExecutor(
                        max_workers=self._depth, thread_name_prefix="zipnn-frame-pipe"
                    )
                pending.append((pipe.submit(self._decode, blob) if pipe else blob, raw_len))
                # up to pipeline_depth frames in flight (1 when serial: the
                # blob then decodes lazily at resolve)
                while len(pending) > (self._depth if pipe else 1):
                    yield resolve(pending.popleft())
        finally:
            if pipe is not None:
                pipe.shutdown(wait=False)

    def frames(self) -> Iterator[bytes]:
        """The remaining decompressed frame bodies in stream order; bytes a
        partial :meth:`read` buffered come first."""
        if self._pending:
            pending, self._pending = self._pending, b""
            yield pending
        while True:
            try:
                yield next(self._frames)
            except StopIteration:
                self._exhausted = True
                return

    def read(self, n: int = -1) -> bytes:
        """File-like read; ``n < 0`` drains the remaining stream."""
        out = bytearray(self._pending)
        self._pending = b""
        while (n < 0 or len(out) < n) and not self._exhausted:
            try:
                out += next(self._frames)
            except StopIteration:
                self._exhausted = True
        if n >= 0 and len(out) > n:
            self._pending = bytes(out[n:])
            del out[n:]
        return bytes(out)

    def close(self) -> None:
        if self._own:
            self._fp.close()

    def __enter__(self) -> "DecompressReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def frame_records(src: PathOrFile) -> Iterator[Tuple[int, int, bytes]]:
    """``(raw_len, comp_len, blob)`` of each data frame of a ``ZNS1``
    container, not decoded (for frame-level tools such as the hub's
    wire/codec overlap model).  One frame in memory at a time."""
    fin, own = _open(src, "rb")
    try:
        hdr = fin.read(_SHDR.size)
        if len(hdr) < _SHDR.size or _SHDR.unpack(hdr)[0] != _STREAM_MAGIC:
            raise ValueError("not a ZNS1 stream")
        while True:
            rec = fin.read(_FRAME.size)
            if len(rec) < _FRAME.size:
                raise IOError("truncated ZNS1 stream (missing end frame)")
            kind, raw_len, comp_len, _crc = _FRAME.unpack(rec)
            if kind not in (_KIND_DATA, _KIND_END):
                raise IOError(f"corrupt ZNS1 frame kind {kind}")
            if kind == _KIND_END:
                return
            blob = _read_exact(fin, comp_len)
            if len(blob) < comp_len:
                raise IOError("truncated ZNS1 frame body")
            yield raw_len, comp_len, blob
    finally:
        if own:
            fin.close()


def compress_file(
    src: PathOrFile,
    dst: PathOrFile,
    dtype_name: str,
    config=None,
    *,
    window_bytes: int = DEFAULT_WINDOW,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    options: Optional[CodecOptions] = None,
    pipeline_depth: int = 2,
    device: Any = "cuda",
) -> Tuple[int, int]:
    """Stream-compress ``src`` into a ``ZNS1`` container at ``dst``, one
    window at a time (peak extra memory O(window)).  Returns
    ``(raw_bytes, comp_bytes)``."""
    options = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend
    )
    fin, own_in = _open(src, "rb")
    try:
        with CompressWriter(
            dst, dtype_name, config, window_bytes=window_bytes, options=options,
            pipeline_depth=pipeline_depth, device=device,
        ) as w:
            while True:
                data = fin.read(w.window)
                if not data:
                    break
                w.write(data)
        return w.raw_bytes, w.comp_bytes
    finally:
        if own_in:
            fin.close()


def decompress_file(
    src: PathOrFile,
    dst: PathOrFile,
    config=None,
    *,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    options: Optional[CodecOptions] = None,
    pipeline_depth: int = 2,
    device: Any = "cuda",
) -> int:
    """Stream-decompress a ``ZNS1`` container; returns raw bytes written."""
    options = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend
    )
    fout, own_out = _open(dst, "wb")
    try:
        with DecompressReader(
            src, config, options=options, pipeline_depth=pipeline_depth, device=device
        ) as r:
            total = 0
            for raw in r.frames():
                fout.write(raw)
                total += len(raw)
        fout.flush()
        return total
    finally:
        if own_out:
            fout.close()
