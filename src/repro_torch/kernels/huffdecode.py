"""Kernel K1: multi-table canonical-Huffman chunk decode.

:func:`huffdecode_chunks` launches the CUDA kernel in
``csrc/huffdecode.cu`` on CUDA tensors and runs
:func:`huffdecode_chunks_plain`, its plain PyTorch version, on CPU
tensors.  It raises on any other device; there is no fallback from the
kernel to the plain version.

Inputs (every tensor on one device, contiguous):

* ``words``     int32[W] — the chunks' payload bytes as big-endian 32-bit
  words (bit ``j`` of a chunk at word bit ``31 - j``), packed compactly:
  chunk ``c`` owns ``words[word_off[c] : word_off[c + 1]]``
  (:func:`pack_words` builds both);
* ``word_off``  int64[C + 1];
* ``plane_ids`` int32[C] — row of ``luts`` each chunk decodes against;
* ``counts``    int32[C] — symbols per chunk (its raw length);
* ``out_off``   int64[C] — where chunk ``c``'s symbols go in ``out``;
* ``luts``      int16[P, 1 << lut_bits] — fused ``(sym << 4) | len``
  canonical LUTs at one shared width ``lut_bits <= MAXL``
  (:func:`fuse_lut` builds a row; the reference kernel fuses
  ``(sym << 8) | len`` into int32, but ``len <= MAXL`` fits four bits, so
  a resident row here is half its size);
* ``out``       uint8[N] — written in place at each chunk's offset.

Returns the final bit cursors, int32[C] (saturated at 2^31 - 1); a valid
chunk's cursor lands inside its payload's final byte, and a runaway one
(corrupt payload) lands past it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = [
    "MAXL", "fuse_lut", "pack_words", "huffdecode_chunks", "huffdecode_chunks_plain",
]

MAXL = 15                      # same cap as the encoder's length-limited tables


def fuse_lut(lut_sym: np.ndarray, lut_len: np.ndarray) -> np.ndarray:
    """One LUT row in K1's fused int16 ``(sym << 4) | len`` form."""
    if lut_len.size and int(lut_len.max()) > MAXL:
        raise ValueError(f"huffdecode: code length above {MAXL}")
    return ((lut_sym.astype(np.int32) << 4) | lut_len.astype(np.int32)).astype(np.int16)


def pack_words(payloads: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Payloads → (int32 big-endian words, int64 word offsets), compact.

    Each payload is zero-padded to whole words; nothing pads a chunk to
    its raw capacity.
    """
    word_off = np.zeros(len(payloads) + 1, dtype=np.int64)
    parts = []
    for k, payload in enumerate(payloads):
        pad = -len(payload) % 4
        w = np.frombuffer(bytes(payload) + b"\x00" * pad, dtype=">u4")
        parts.append(w)
        word_off[k + 1] = word_off[k] + w.size
    words = (
        np.concatenate(parts).astype(np.uint32) if parts
        else np.zeros(0, np.uint32)
    )
    return words.view(np.int32), word_off


def _check_args(words, word_off, plane_ids, counts, out_off, luts, out) -> int:
    dev = words.device
    want = (
        ("words", words, torch.int32, 1),
        ("word_off", word_off, torch.int64, 1),
        ("plane_ids", plane_ids, torch.int32, 1),
        ("counts", counts, torch.int32, 1),
        ("out_off", out_off, torch.int64, 1),
        ("luts", luts, torch.int16, 2),
        ("out", out, torch.uint8, 1),
    )
    for name, t, dtype, ndim in want:
        if t.device != dev:
            raise ValueError(f"huffdecode: {name} is on {t.device}, words on {dev}")
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(
                f"huffdecode: {name} must be a contiguous {ndim}-d {dtype} "
                f"tensor, got {t.dtype} of shape {tuple(t.shape)}"
            )
    c = plane_ids.numel()
    if counts.numel() != c or out_off.numel() != c or word_off.numel() != c + 1:
        raise ValueError("huffdecode: per-chunk arrays disagree on the chunk count")
    lut_n = luts.shape[1]
    lut_bits = lut_n.bit_length() - 1
    if lut_n != 1 << lut_bits or not 1 <= lut_bits <= MAXL:
        raise ValueError(f"huffdecode: LUT width {lut_n} is not 2^L with 1 <= L <= {MAXL}")
    return lut_bits


@functools.cache
def _launcher():
    fn = _build.load("huffdecode").huffdecode_chunks_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    )
    fn.restype = ctypes.c_int
    return fn


def huffdecode_chunks(
    words: torch.Tensor,
    word_off: torch.Tensor,
    plane_ids: torch.Tensor,
    counts: torch.Tensor,
    out_off: torch.Tensor,
    luts: torch.Tensor,
    out: torch.Tensor,
) -> torch.Tensor:
    """Decode every chunk into ``out``; return the final bit cursors.

    The caller guarantees the index arrays are in range (the feed builds
    them from a validated container): ``plane_ids < P``,
    ``out_off[c] + counts[c] <= N`` and ``word_off`` nondecreasing within
    ``[0, W]``.  The payload bits themselves may be anything.
    """
    lut_bits = _check_args(words, word_off, plane_ids, counts, out_off, luts, out)
    if words.device.type == "cpu":
        return huffdecode_chunks_plain(
            words, word_off, plane_ids, counts, out_off, luts, out
        )
    if words.device.type != "cuda":
        raise ValueError(f"huffdecode: unsupported device {words.device}")
    fn = _launcher()
    cursors = torch.empty(plane_ids.numel(), dtype=torch.int32, device=words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = fn(
        words.data_ptr(), word_off.data_ptr(), plane_ids.data_ptr(),
        counts.data_ptr(), out_off.data_ptr(), luts.data_ptr(),
        lut_bits, plane_ids.numel(), out.data_ptr(), cursors.data_ptr(), stream,
    )
    _build.check("huffdecode", rc, "huffdecode_chunks launch")
    huffdecode_chunks.launches += 1
    return cursors


huffdecode_chunks.launches = 0


def huffdecode_chunks_plain(
    words: torch.Tensor,
    word_off: torch.Tensor,
    plane_ids: torch.Tensor,
    counts: torch.Tensor,
    out_off: torch.Tensor,
    luts: torch.Tensor,
    out: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch K1: the same decode, one symbol of every live chunk per
    step (lockstep across chunks, serial within a chunk).

    Bit work runs in int64 lanes with masks (CPU PyTorch has no shifts on
    unsigned 32-bit tensors).  A read past a chunk's own words yields 0,
    exactly as in the kernel.
    """
    dev = words.device
    c = plane_ids.numel()
    lut_bits = luts.shape[1].bit_length() - 1
    shift = 32 - lut_bits
    # one trailing zero word: every read past a chunk's own words lands on it
    w = torch.cat([words.to(torch.int64) & 0xFFFFFFFF,
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    zero_word = w.numel() - 1
    start = word_off[:-1]
    nw = word_off[1:] - start
    lut = luts.reshape(-1).to(torch.int64)
    row = plane_ids.to(torch.int64) << lut_bits
    cnt = counts.to(torch.int64)
    final = torch.zeros(c, dtype=torch.int64, device=dev)

    # Live set shrinks only at the distinct chunk lengths.
    ends = sorted(set(int(x) for x in cnt.tolist()))
    live = torch.arange(c, device=dev)
    bitpos = torch.zeros(c, dtype=torch.int64, device=dev)
    i = 0
    for end in ends:
        s, n, r, dst = start[live], nw[live], row[live], out_off[live]
        while i < end:
            w0 = bitpos >> 5
            o = bitpos & 31
            a = w[torch.where(w0 < n, s + w0, zero_word)]
            b = w[torch.where(w0 + 1 < n, s + w0 + 1, zero_word)]
            win = ((a << o) & 0xFFFFFFFF) | ((b >> 1) >> (31 - o))
            v = lut[r + (win >> shift)]
            out[dst + i] = (v >> 4).to(torch.uint8)
            bitpos = bitpos + (v & 0xF)
            i += 1
        done = cnt[live] == end
        final[live[done]] = bitpos[done]
        keep = ~done
        live, bitpos = live[keep], bitpos[keep]
    return torch.clamp(final, max=2**31 - 1).to(torch.int32)
