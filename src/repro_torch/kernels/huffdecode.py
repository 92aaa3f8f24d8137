"""Kernel K1: multi-table canonical-Huffman chunk decode.

Three launch forms of the CUDA kernels in ``csrc/huffdecode.cu``, each
with its plain PyTorch version for CPU tensors (a wrapper raises on any
other device; there is no fallback from a kernel to a plain version):

* :func:`huffdecode_index` — the serial decode (one thread per chunk) that
  also writes the **sync-point index**: the bit cursor before every
  ``sync_every``-th symbol of each chunk.  A resident payload feed runs it
  once, at build;
* :func:`huffdecode_chunks` with ``sync`` — the decode the serving ring
  runs every step: the index cuts each chunk into ``ceil(count /
  sync_every)`` sub-streams decoded in parallel (one block per chunk, one
  thread per sub-stream, LUT row and words in shared memory);
* :func:`huffdecode_chunks` without ``sync`` (:func:`huffdecode_serial`)
  — the serial decode alone, for one-shot decodes that have no index.

The blob format is untouched: the index lives beside the resident words,
never in a ZNN1 stream.  Inputs (every tensor on one device, contiguous):

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
* ``out``       uint8[N] — written in place at each chunk's offset;
* ``sync_off``  int64[C + 1] — chunk ``c``'s index entries are
  ``sync[sync_off[c] : sync_off[c + 1]]``, ``ceil(counts[c] /
  sync_every)`` of them (:func:`sync_offsets` builds it);
* ``sync``      int32[sync_off[C]] — entry ``k`` of chunk ``c``: the bit
  cursor, from the chunk's first word, before symbol ``k * sync_every``.

Every form returns the final bit cursors, int32[C] (saturated at
2^31 - 1); a valid chunk's cursor lands inside its payload's final byte,
and a runaway one (corrupt payload) lands past it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = [
    "MAXL", "SYNC_EVERY", "fuse_lut", "pack_words", "sync_offsets",
    "huffdecode_chunks", "huffdecode_chunks_plain", "huffdecode_serial",
    "huffdecode_index", "huffdecode_index_plain", "sync_word_cap",
]

MAXL = 15                      # same cap as the encoder's length-limited tables
# Symbols per sub-stream of the sync decode.  Its index costs 4 bytes per
# SYNC_EVERY symbols: 0.57% of repro_gpt_100m's resident feeds at 512.
SYNC_EVERY = 512


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


def sync_offsets(counts: np.ndarray, sync_every: int = SYNC_EVERY) -> np.ndarray:
    """Per-chunk offsets (int64[C + 1]) of the sync index: chunk ``c`` has
    ``ceil(counts[c] / sync_every)`` entries."""
    n = -(-np.asarray(counts, dtype=np.int64) // sync_every)
    return np.concatenate([[0], np.cumsum(n)]).astype(np.int64)


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
        _check_tensor(name, t, dtype, ndim, dev)
    c = plane_ids.numel()
    if counts.numel() != c or out_off.numel() != c or word_off.numel() != c + 1:
        raise ValueError("huffdecode: per-chunk arrays disagree on the chunk count")
    lut_n = luts.shape[1]
    lut_bits = lut_n.bit_length() - 1
    if lut_n != 1 << lut_bits or not 1 <= lut_bits <= MAXL:
        raise ValueError(f"huffdecode: LUT width {lut_n} is not 2^L with 1 <= L <= {MAXL}")
    return lut_bits


def _check_tensor(name, t, dtype, ndim, dev) -> None:
    if t.device != dev:
        raise ValueError(f"huffdecode: {name} is on {t.device}, words on {dev}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"huffdecode: {name} must be a contiguous {ndim}-d {dtype} "
            f"tensor, got {t.dtype} of shape {tuple(t.shape)}"
        )


def _check_sync(words, plane_ids, sync_off, sync, sync_every) -> None:
    _check_tensor("sync_off", sync_off, torch.int64, 1, words.device)
    if sync is not None:
        _check_tensor("sync", sync, torch.int32, 1, words.device)
    if sync_off.numel() != plane_ids.numel() + 1:
        raise ValueError("huffdecode: sync_off disagrees with the chunk count")
    if sync_every < 1:
        raise ValueError(f"huffdecode: sync_every must be >= 1, got {sync_every}")


@functools.cache
def _lib():
    lib = _build.load("huffdecode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.huffdecode_chunks_launch.argtypes = [p] * 6 + [i, i] + [p] * 4 + [i, p]
    lib.huffdecode_chunks_launch.restype = i
    lib.huffdecode_sync_launch.argtypes = [p] * 6 + [i, i, p, p, i, p, p, p]
    lib.huffdecode_sync_launch.restype = i
    lib.huffdecode_sync_word_cap.argtypes = [i, ctypes.POINTER(ctypes.c_longlong)]
    lib.huffdecode_sync_word_cap.restype = i
    return lib


def sync_word_cap(lut_bits: int, device=None) -> int:
    """Words of one chunk that a block of the sync kernel stages in shared
    memory on ``device`` (a CUDA device); a chunk with more words reads
    them from global memory."""
    cap = ctypes.c_longlong()
    with torch.cuda.device(device):
        rc = _lib().huffdecode_sync_word_cap(lut_bits, ctypes.byref(cap))
    _build.check("huffdecode", rc, "huffdecode: the card's shared-memory limit")
    return cap.value


def _serial_launch(fn, words, word_off, plane_ids, counts, out_off, luts, out,
                   lut_bits, sync_off=None, sync=None, sync_every=SYNC_EVERY):
    """One launch of the serial kernel, counted on ``fn``."""
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"huffdecode: unsupported device {dev}")
    cursors = torch.empty(plane_ids.numel(), dtype=torch.int32, device=dev)
    rc = _lib().huffdecode_chunks_launch(
        words.data_ptr(), word_off.data_ptr(), plane_ids.data_ptr(),
        counts.data_ptr(), out_off.data_ptr(), luts.data_ptr(),
        lut_bits, plane_ids.numel(), out.data_ptr(), cursors.data_ptr(),
        None if sync_off is None else sync_off.data_ptr(),
        None if sync is None else sync.data_ptr(), sync_every,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("huffdecode", rc, f"{fn.__name__} launch")
    _build.count_launch(fn)
    return cursors


def huffdecode_chunks(
    words: torch.Tensor,
    word_off: torch.Tensor,
    plane_ids: torch.Tensor,
    counts: torch.Tensor,
    out_off: torch.Tensor,
    luts: torch.Tensor,
    out: torch.Tensor,
    sync: Optional[torch.Tensor] = None,
    sync_off: Optional[torch.Tensor] = None,
    sync_every: int = SYNC_EVERY,
) -> torch.Tensor:
    """Decode every chunk into ``out``; return the final bit cursors.

    With ``sync`` and ``sync_off`` (an index from :func:`huffdecode_index`
    over the same words and counts at the same ``sync_every``) the chunks
    decode as parallel sub-streams; without them, serially
    (:func:`huffdecode_serial`).  Symbols and cursors are the same either
    way on a valid stream.

    The caller guarantees the index arrays are in range (the feed builds
    them from a validated container): ``plane_ids < P``,
    ``out_off[c] + counts[c] <= N``, ``word_off`` nondecreasing within
    ``[0, W]`` and ``sync_off`` as :func:`sync_offsets` gives it.  The
    payload bits themselves may be anything.
    """
    if (sync is None) != (sync_off is None):
        raise ValueError("huffdecode: pass sync and sync_off together")
    if sync is None:
        return huffdecode_serial(words, word_off, plane_ids, counts, out_off, luts, out)
    lut_bits = _check_args(words, word_off, plane_ids, counts, out_off, luts, out)
    _check_sync(words, plane_ids, sync_off, sync, sync_every)
    dev = words.device
    if dev.type == "cpu":
        return huffdecode_chunks_plain(words, word_off, plane_ids, counts, out_off, luts, out,
                                       sync, sync_off, sync_every)
    if dev.type != "cuda":
        raise ValueError(f"huffdecode: unsupported device {dev}")
    if luts.data_ptr() % 4:
        raise ValueError("huffdecode: luts must start on a 4-byte boundary")
    cursors = torch.empty(plane_ids.numel(), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().huffdecode_sync_launch(
            words.data_ptr(), word_off.data_ptr(), plane_ids.data_ptr(),
            counts.data_ptr(), out_off.data_ptr(), luts.data_ptr(), lut_bits,
            plane_ids.numel(), sync_off.data_ptr(), sync.data_ptr(), sync_every,
            out.data_ptr(), cursors.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("huffdecode", rc, "huffdecode_chunks (sync) launch")
    _build.count_launch(huffdecode_chunks)
    return cursors


huffdecode_chunks.launches = 0


def huffdecode_serial(
    words: torch.Tensor,
    word_off: torch.Tensor,
    plane_ids: torch.Tensor,
    counts: torch.Tensor,
    out_off: torch.Tensor,
    luts: torch.Tensor,
    out: torch.Tensor,
) -> torch.Tensor:
    """The serial decode without an index (one thread per chunk)."""
    lut_bits = _check_args(words, word_off, plane_ids, counts, out_off, luts, out)
    if words.device.type == "cpu":
        return huffdecode_chunks_plain(words, word_off, plane_ids, counts, out_off, luts, out)
    return _serial_launch(huffdecode_serial, words, word_off, plane_ids, counts, out_off,
                          luts, out, lut_bits)


huffdecode_serial.launches = 0


def huffdecode_index(
    words: torch.Tensor,
    word_off: torch.Tensor,
    plane_ids: torch.Tensor,
    counts: torch.Tensor,
    out_off: torch.Tensor,
    luts: torch.Tensor,
    out: torch.Tensor,
    sync_off: torch.Tensor,
    sync_every: int = SYNC_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serial decode that also writes the sync index; returns
    ``(cursors, sync)``.  ``sync`` is allocated here (``sync_off[-1]``
    entries, read back to the host once)."""
    lut_bits = _check_args(words, word_off, plane_ids, counts, out_off, luts, out)
    _check_sync(words, plane_ids, sync_off, None, sync_every)
    if words.device.type == "cpu":
        return huffdecode_index_plain(words, word_off, plane_ids, counts, out_off, luts, out,
                                      sync_off, sync_every)
    if words.device.type != "cuda":
        raise ValueError(f"huffdecode: unsupported device {words.device}")
    sync = torch.empty(int(sync_off[-1]), dtype=torch.int32, device=words.device)
    cursors = _serial_launch(huffdecode_index, words, word_off, plane_ids, counts, out_off,
                             luts, out, lut_bits, sync_off, sync, sync_every)
    return cursors, sync


huffdecode_index.launches = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
#
# Bit work runs in int64 lanes with masks (CPU PyTorch has no shifts on
# unsigned 32-bit tensors).  A read past a chunk's own words yields 0,
# exactly as in the kernels.

def _lanes(words, word_off, plane_ids, luts):
    """Words with one trailing zero word (every read past a chunk lands on
    it), and per-chunk start word, word count and LUT row base."""
    dev = words.device
    lut_bits = luts.shape[1].bit_length() - 1
    w = torch.cat([words.to(torch.int64) & 0xFFFFFFFF,
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    start = word_off[:-1]
    return (w, start, word_off[1:] - start, plane_ids.to(torch.int64) << lut_bits,
            luts.reshape(-1).to(torch.int64), 32 - lut_bits)


def _step(w, s, n, r, lut, shift, bitpos):
    """One symbol of every lane at its ``bitpos``: returns (sym, len)."""
    zero_word = w.numel() - 1
    w0 = bitpos >> 5
    o = bitpos & 31
    a = w[torch.where((w0 >= 0) & (w0 < n), s + w0, zero_word)]
    b = w[torch.where((w0 >= -1) & (w0 + 1 < n), s + w0 + 1, zero_word)]
    win = ((a << o) & 0xFFFFFFFF) | ((b >> 1) >> (31 - o))
    v = lut[r + (win >> shift)]
    return (v >> 4).to(torch.uint8), v & 0xF


def _serial_plain(words, word_off, plane_ids, counts, out_off, luts, out,
                  sync_off=None, sync_every=SYNC_EVERY):
    """One symbol of every live chunk per step (lockstep across chunks,
    serial within a chunk); with ``sync_off``, also the index."""
    dev = words.device
    c = plane_ids.numel()
    w, start, nw, row, lut, shift = _lanes(words, word_off, plane_ids, luts)
    cnt = counts.to(torch.int64)
    final = torch.zeros(c, dtype=torch.int64, device=dev)
    sync = None
    if sync_off is not None:
        sync = torch.zeros(int(sync_off[-1]), dtype=torch.int32, device=dev)

    # Live set shrinks only at the distinct chunk lengths.
    ends = sorted(set(int(x) for x in cnt.tolist()))
    live = torch.arange(c, device=dev)
    bitpos = torch.zeros(c, dtype=torch.int64, device=dev)
    i = 0
    for end in ends:
        s, n, r, dst = start[live], nw[live], row[live], out_off[live]
        while i < end:
            if sync is not None and i % sync_every == 0:
                sync[sync_off[live] + i // sync_every] = torch.clamp(
                    bitpos, max=2**31 - 1).to(torch.int32)
            sym, length = _step(w, s, n, r, lut, shift, bitpos)
            out[dst + i] = sym
            bitpos = bitpos + length
            i += 1
        done = cnt[live] == end
        final[live[done]] = bitpos[done]
        keep = ~done
        live, bitpos = live[keep], bitpos[keep]
    return torch.clamp(final, max=2**31 - 1).to(torch.int32), sync


def _sync_plain(words, word_off, plane_ids, counts, out_off, luts, out,
                sync, sync_off, sync_every):
    """Every sub-stream of every chunk in lockstep, ``sync_every`` steps."""
    dev = words.device
    c = plane_ids.numel()
    w, start, nw, row, lut, shift = _lanes(words, word_off, plane_ids, luts)
    cnt = counts.to(torch.int64)
    nsub = (cnt + sync_every - 1) // sync_every
    chunk = torch.repeat_interleave(torch.arange(c, device=dev), nsub)
    first_lane = torch.cumsum(nsub, 0) - nsub
    k = torch.arange(chunk.numel(), device=dev) - first_lane[chunk]
    bitpos = sync[sync_off[chunk] + k].to(torch.int64)
    n_sym = torch.clamp(cnt[chunk] - k * sync_every, max=sync_every)
    dst = out_off[chunk] + k * sync_every
    s, n, r = start[chunk], nw[chunk], row[chunk]
    end = torch.zeros_like(bitpos)
    for i in range(int(n_sym.max()) if n_sym.numel() else 0):
        live = n_sym > i
        sym, length = _step(w, s, n, r, lut, shift, bitpos)
        out[dst[live] + i] = sym[live]
        bitpos = bitpos + length
        end = torch.where(n_sym == i + 1, bitpos, end)
    final = torch.zeros(c, dtype=torch.int64, device=dev)
    has = nsub > 0
    final[has] = end[(first_lane + nsub - 1)[has]]
    return torch.clamp(final, max=2**31 - 1).to(torch.int32)


def huffdecode_chunks_plain(
    words: torch.Tensor,
    word_off: torch.Tensor,
    plane_ids: torch.Tensor,
    counts: torch.Tensor,
    out_off: torch.Tensor,
    luts: torch.Tensor,
    out: torch.Tensor,
    sync: Optional[torch.Tensor] = None,
    sync_off: Optional[torch.Tensor] = None,
    sync_every: int = SYNC_EVERY,
) -> torch.Tensor:
    """Plain PyTorch K1 decode.  Without an index: one symbol of every live
    chunk per step, serial within a chunk.  With ``sync``/``sync_off``:
    every sub-stream of every chunk in lockstep for ``sync_every`` steps,
    as the sync kernel cuts them."""
    _check_args(words, word_off, plane_ids, counts, out_off, luts, out)
    if (sync is None) != (sync_off is None):
        raise ValueError("huffdecode: pass sync and sync_off together")
    if sync is None:
        return _serial_plain(words, word_off, plane_ids, counts, out_off, luts, out)[0]
    _check_sync(words, plane_ids, sync_off, sync, sync_every)
    return _sync_plain(words, word_off, plane_ids, counts, out_off, luts, out,
                       sync, sync_off, sync_every)


def huffdecode_index_plain(
    words: torch.Tensor,
    word_off: torch.Tensor,
    plane_ids: torch.Tensor,
    counts: torch.Tensor,
    out_off: torch.Tensor,
    luts: torch.Tensor,
    out: torch.Tensor,
    sync_off: torch.Tensor,
    sync_every: int = SYNC_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch index pass: the serial decode, recording each live
    chunk's cursor at every multiple of ``sync_every``."""
    _check_args(words, word_off, plane_ids, counts, out_off, luts, out)
    _check_sync(words, plane_ids, sync_off, None, sync_every)
    return _serial_plain(words, word_off, plane_ids, counts, out_off, luts, out,
                         sync_off, sync_every)
