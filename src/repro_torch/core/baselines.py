"""Baseline compressors the paper compares ZipNN against.  A port of
``repro.core.baselines``: the same stdlib ``zlib`` stand-ins, byte for byte.

The paper's baseline family is "LZ + entropy" (zstd, zlib) and "fast LZ"
(lz4, snappy).  Without zstd/lz4 binaries:

  * ``zstd``-class LZ+entropy  → zlib level 6        (same family, §2.3)
  * ``zstd -1``-class          → zlib level 1
  * fast-LZ (lz4/snappy) proxy → zlib level 1 w/ Z_FILTERED (match-light)
  * zstd's Huffman-only path   → zlib Z_HUFFMAN_ONLY
  * EE+Zstd (paper Table 3)    → exponent extraction + zlib on each plane

Inputs are bytes, as in the reference; a tensor is taken too, as its
bytes.  The compressors run on the host.  :func:`ee_zlib` of a tensor
splits its planes with K4 on the tensor's device (``stats.kernel_planes``;
its plain version on a CPU tensor) and downloads the planes, then runs
``zlib`` per plane.
"""

from __future__ import annotations

import time
import zlib
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from . import bitlayout
from .stats import kernel_planes

__all__ = [
    "BASELINES",
    "run_baseline",
    "decompress_time",
    "ee_zlib",
    "zlib6",
    "zlib1",
    "huffman_only",
    "fast_lz",
]


def _raw(data: Any) -> bytes:
    """The bytes of ``data``: bytes-like as they are, a tensor's elements
    downloaded."""
    if isinstance(data, torch.Tensor):
        return data.reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return bytes(data)


def _timed(fn: Callable[[Any], bytes], data: Any) -> Tuple[bytes, float]:
    t0 = time.perf_counter()
    out = fn(data)
    return out, time.perf_counter() - t0


def zlib6(data: Any) -> bytes:
    return zlib.compress(_raw(data), 6)


def zlib1(data: Any) -> bytes:
    return zlib.compress(_raw(data), 1)


def huffman_only(data: Any) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    return co.compress(_raw(data)) + co.flush()


def fast_lz(data: Any) -> bytes:
    co = zlib.compressobj(1, zlib.DEFLATED, -15, 9, zlib.Z_FILTERED)
    return co.compress(_raw(data)) + co.flush()


def _tensor_planes(data: torch.Tensor, layout: bitlayout.BitLayout):
    """(planes on the host, tail bytes) of a tensor's bytes, or None where
    K4 does not cover the layout."""
    raw = data.reshape(-1).contiguous().view(torch.uint8)
    tail = raw.numel() % layout.itemsize
    body = raw[: raw.numel() - tail]
    if body.storage_offset() % layout.itemsize:
        body = body.clone()                   # element bits need an aligned view
    planes = kernel_planes(body, layout)
    if planes is None:
        return None
    return [p.cpu().numpy() for p in planes], raw[raw.numel() - tail:].cpu().numpy().tobytes()


def ee_zlib(data: Any, dtype_name: str, level: int = 6) -> bytes:
    """Exponent-Extraction + zlib per plane (paper Table 3's 'EE+Zstd').

    Each plane's blob after its 8-byte little-endian length; bytes past the
    last whole element follow unplaned."""
    layout = bitlayout.layout_for(dtype_name)
    split = _tensor_planes(data, layout) if isinstance(data, torch.Tensor) else None
    if split is not None:
        planes, tail = split
    else:
        buf = np.frombuffer(_raw(data), dtype=np.uint8)
        n_tail = buf.size % layout.itemsize
        planes = bitlayout.to_planes(buf[: buf.size - n_tail], layout)
        tail = bytes(buf[buf.size - n_tail:])
    blobs = [zlib.compress(p.tobytes(), level) for p in planes]
    return b"".join(len(b).to_bytes(8, "little") + b for b in blobs) + tail


BASELINES: Dict[str, Callable[[Any], bytes]] = {
    "zlib": zlib6,
    "zlib-1": zlib1,
    "huffman-only(zlib)": huffman_only,
    "fast-lz": fast_lz,
}


def run_baseline(name: str, data: Any) -> Tuple[int, float]:
    """Returns (compressed_size_bytes, seconds)."""
    out, dt = _timed(BASELINES[name], data)
    return len(out), dt


def decompress_time(name: str, data: Any) -> Tuple[bytes, float]:
    comp = BASELINES[name](data)
    t0 = time.perf_counter()
    if name in ("huffman-only(zlib)", "fast-lz"):
        out = zlib.decompress(comp, -15)
    else:
        out = zlib.decompress(comp)
    return out, time.perf_counter() - t0
