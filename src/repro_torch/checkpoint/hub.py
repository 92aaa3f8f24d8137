"""Model-hub transfer model (paper §5.3, Fig. 10).

Models the paper's measured channel classes (first download, cached
download, upload; cloud and home) and reports the end-to-end time with and
without ZipNN: transfer of the compressed bytes plus the codec against
transfer of the raw bytes.  Codec times are *measured* here, on the host
or the card as ``options`` and ``device`` route them; only the wire time
is modelled, as the paper separates the two terms.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

from ..core import engine, zipnn
from ..core.options import CodecOptions, resolve_options

__all__ = ["CHANNELS", "TransferReport", "simulate_transfer", "simulate_file_transfer"]

# Channel bandwidths (MB/s) — paper §5.3 measurements.
CHANNELS: Dict[str, float] = {
    "upload_cloud": 20.0,
    "first_download_cloud": 30.0,
    "cached_download_cloud": 125.0,
    "first_download_home": 10.0,
    "cached_download_home": 40.0,
}


@dataclasses.dataclass
class TransferReport:
    channel: str
    raw_bytes: int
    comp_bytes: int
    wire_raw_s: float
    wire_comp_s: float
    codec_s: float
    # Prefetch-overlapped download (streamed transfers only): frame i
    # decompresses while frame i+1 crosses the modelled wire, so only codec
    # time that outruns the wire is exposed.  0.0 when not overlapped.
    codec_overlap_s: float = 0.0        # codec time NOT hidden by the wire
    total_comp_overlap_s: float = 0.0   # pipelined end-to-end time

    @property
    def total_raw_s(self) -> float:
        return self.wire_raw_s

    @property
    def total_comp_s(self) -> float:
        return self.wire_comp_s + self.codec_s

    @property
    def speedup(self) -> float:
        return self.total_raw_s / max(self.total_comp_s, 1e-9)

    @property
    def overlapped_speedup(self) -> float:
        """Speedup with wire/codec overlap; equals :attr:`speedup` when the
        transfer was not overlapped."""
        base = self.total_comp_overlap_s or self.total_comp_s
        return self.total_raw_s / max(base, 1e-9)


def simulate_transfer(
    data: bytes,
    dtype_name: str,
    channel: str,
    *,
    direction: str = "download",
    config: zipnn.ZipNNConfig = zipnn.DEFAULT,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    options: Optional[CodecOptions] = None,
    device: Any = "cuda",
) -> TransferReport:
    """Measure one hub transfer of ``data``: its compress (upload) or
    decompress (download) time, and the wire times of the raw and the
    compressed bytes."""
    opts = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend
    )
    bw = CHANNELS[channel] * 1e6
    t0 = time.perf_counter()
    blob = zipnn.compress_bytes(data, dtype_name, config, options=opts, device=device)
    t_comp = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = zipnn.decompress_bytes(blob, config, options=opts, device=device)
    t_dec = time.perf_counter() - t0
    if back != bytes(data):
        # an exception, not an assert: the losslessness check must survive -O
        raise IOError("hub transfer must be lossless: round-trip mismatch")
    return TransferReport(
        channel=channel,
        raw_bytes=len(data),
        comp_bytes=len(blob),
        wire_raw_s=len(data) / bw,
        wire_comp_s=len(blob) / bw,
        codec_s=t_comp if direction == "upload" else t_dec,
    )


def _overlapped_download(
    comp_path: str, config: zipnn.ZipNNConfig, opts: CodecOptions, bw: float, device: Any
) -> Tuple[float, float]:
    """Pipelined download time over a ``ZNS1`` container.

    Frames are independent, so a client can decompress frame i while frame
    i+1 is on the wire.  Each frame's decode is measured and its wire time
    modelled from its size; the pipeline exposes only codec time that
    outruns the wire:

        total = wire(header) + wire(f0) + Σ max(wire(f_{i+1}), dec(f_i))
                + dec(f_last)

    One frame in memory at a time.  Returns ``(total_overlap_s,
    exposed_codec_s)``.
    """
    fixed = (engine._SHDR.size + engine._FRAME.size) / bw   # header + end frame
    total = wire_total = fixed
    prev_dec = None
    for _raw_len, comp_len, blob in engine.frame_records(comp_path):
        wire = (engine._FRAME.size + comp_len) / bw
        wire_total += wire
        total += wire if prev_dec is None else max(wire, prev_dec)
        t0 = time.perf_counter()
        zipnn.decompress_bytes(blob, config, options=opts, device=device)
        prev_dec = time.perf_counter() - t0
    if prev_dec is not None:
        total += prev_dec
    return total, max(total - wire_total, 0.0)


def simulate_file_transfer(
    path: str,
    dtype_name: str,
    channel: str,
    *,
    direction: str = "download",
    config: zipnn.ZipNNConfig = zipnn.DEFAULT,
    window_bytes: Optional[int] = None,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    options: Optional[CodecOptions] = None,
    device: Any = "cuda",
) -> TransferReport:
    """:func:`simulate_transfer` for a file, streamed through the engine's
    windowed ``ZNS1`` container (O(window) memory).  Downloads also report
    the prefetch-overlapped time (:attr:`TransferReport.overlapped_speedup`)."""
    opts = resolve_options(
        options, threads=threads, backend=backend, entropy_backend=entropy_backend
    )
    window = engine.DEFAULT_WINDOW if window_bytes is None else window_bytes
    bw = CHANNELS[channel] * 1e6
    with tempfile.TemporaryDirectory() as td:
        comp_path = os.path.join(td, "model.znns")
        t0 = time.perf_counter()
        raw_bytes, comp_bytes = engine.compress_file(
            path, comp_path, dtype_name, config,
            window_bytes=window, options=opts, device=device,
        )
        t_comp = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(os.devnull, "wb") as sink:
            n = engine.decompress_file(comp_path, sink, config, options=opts, device=device)
        t_dec = time.perf_counter() - t0
        overlap_total = overlap_codec = 0.0
        if direction == "download":
            overlap_total, overlap_codec = _overlapped_download(
                comp_path, config, opts, bw, device
            )
    if n != raw_bytes:
        raise IOError("streamed hub transfer must be lossless")
    return TransferReport(
        channel=channel,
        raw_bytes=raw_bytes,
        comp_bytes=comp_bytes,
        wire_raw_s=raw_bytes / bw,
        wire_comp_s=comp_bytes / bw,
        codec_s=t_comp if direction == "upload" else t_dec,
        codec_overlap_s=overlap_codec,
        total_comp_overlap_s=overlap_total,
    )
