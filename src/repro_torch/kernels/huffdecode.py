"""Kernel K1: multi-table canonical-Huffman chunk decode.

Three launch forms of the CUDA kernels in ``csrc/huffdecode.cu``, each
with its plain PyTorch version for CPU tensors (a wrapper raises on any
other device; there is no fallback from a kernel to a plain version):

* :func:`huffdecode_serial` — the decode with no index, for one-shot
  decodes (restores, file frames, deltas, the KV tier's cold blocks): the
  **self-synchronising** kernel, one block per chunk.  The chunk's bits are
  cut into segments of ``seg_bits`` that start at guessed offsets; each
  segment decodes to its end, segments restart from their predecessor's
  end until nothing changes (the fixpoint is the serial decode's
  partition), then a scan of the segments' symbol counts places each and
  they decode again, in parallel, writing symbols.  What lies past a
  chunk's words, or past a length-0 entry, is written in closed form;
* :func:`huffdecode_index` — the same kernel asked for the **sync-point
  index** (and, optionally, the symbols): the bit cursor before every
  ``sync_every``-th symbol of each chunk.  A resident payload feed runs it
  once, at build, for the index and the cursors;
* :func:`huffdecode_chunks` with ``sync`` — the decode the serving ring
  runs every step: the index cuts each chunk into ``ceil(count /
  sync_every)`` sub-streams decoded in parallel (one block per chunk, one
  thread per sub-stream, LUT row and words in shared memory).

:func:`huffdecode_chain` launches the first design, one thread walking a
whole chunk; no path runs it, it is the baseline the measurements time
beside the self-synchronising kernel.

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
* ``out``       uint8[N] — written in place at each chunk's offset (the
  index form may take None: no symbols written);
* ``sync_off``  int64[C + 1] — chunk ``c``'s index entries are
  ``sync[sync_off[c] : sync_off[c + 1]]``, ``ceil(counts[c] /
  sync_every)`` of them (:func:`sync_offsets` builds it);
* ``sync``      int32[sync_off[C]] — entry ``k`` of chunk ``c``: the bit
  cursor, from the chunk's first word, before symbol ``k * sync_every``.

Every form returns the final bit cursors, int32[C] (saturated at
2^31 - 1); a valid chunk's cursor lands inside its payload's final byte,
and a runaway one (corrupt payload) lands past it.  Every form gives the
same symbols, cursors and index on every input, valid or not.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = [
    "MAXL", "SYNC_EVERY", "SEG_BITS", "fuse_lut", "pack_words", "sync_offsets",
    "huffdecode_chunks", "huffdecode_chunks_plain", "huffdecode_serial",
    "huffdecode_index", "huffdecode_index_plain", "huffdecode_chain",
    "huffdecode_chain_plain", "huffdecode_selfsync_plain", "sync_word_cap",
]

MAXL = 15                      # same cap as the encoder's length-limited tables
# Symbols per sub-stream of the sync decode.  Its index costs 4 bytes per
# SYNC_EVERY symbols: 0.57% of repro_gpt_100m's resident feeds at 512.
SYNC_EVERY = 512
# Bits per segment of the self-synchronising decode: a segment's symbols
# are a chain of about SEG_BITS / 2.6 steps on a bf16 exponent plane.
# Shorter segments make shorter chains and more of them; 544 bits (17
# words, so a warp's segments start on distinct shared-memory banks) timed
# fastest of 480 to 2,048 on an H100 at 3072x768 and 6144x24576 leaves
# (kernels/k1_segment_sweep.py, chip_smoke.py's measure_k1).
SEG_BITS = 544


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
        if t is not None or name != "out":
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
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.huffdecode_chain_launch.argtypes = [p] * 6 + [i, i] + [p] * 4 + [i, p]
    lib.huffdecode_chain_launch.restype = i
    lib.huffdecode_sync_launch.argtypes = [p] * 6 + [i, i, p, p, i, p, p, p]
    lib.huffdecode_sync_launch.restype = i
    lib.huffdecode_sync_word_cap.argtypes = [i, ctypes.POINTER(ll)]
    lib.huffdecode_sync_word_cap.restype = i
    lib.huffdecode_selfsync_launch.argtypes = [p] * 6 + [i, i, p, i, ll] + [p] * 5
    lib.huffdecode_selfsync_launch.restype = i
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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_rounds(rounds, plane_ids) -> None:
    if rounds is not None:
        _check_tensor("rounds", rounds, torch.int32, 1, plane_ids.device)
        if rounds.numel() != plane_ids.numel():
            raise ValueError("huffdecode: rounds disagrees with the chunk count")


def _selfsync(fn, words, word_off, plane_ids, counts, out_off, luts, out, sync_off,
              sync_every, seg_bits, rounds):
    """One checked launch of the self-synchronising kernel, counted on
    ``fn``, or its plain version for CPU tensors; returns ``(cursors,
    sync)`` (``sync`` None without ``sync_off``)."""
    lut_bits = _check_args(words, word_off, plane_ids, counts, out_off, luts, out)
    if sync_off is not None:
        _check_sync(words, plane_ids, sync_off, None, sync_every)
    _check_rounds(rounds, plane_ids)
    if seg_bits < 16:
        raise ValueError(f"huffdecode: seg_bits must be >= 16, got {seg_bits}")
    dev = words.device
    if dev.type == "cpu":
        return huffdecode_selfsync_plain(words, word_off, plane_ids, counts, out_off, luts, out,
                                         sync_off, sync_every, seg_bits, rounds)
    if dev.type != "cuda":
        raise ValueError(f"huffdecode: unsupported device {dev}")
    if luts.data_ptr() % 4:
        raise ValueError("huffdecode: luts must start on a 4-byte boundary")
    sync = None
    if sync_off is not None:
        sync = torch.empty(int(sync_off[-1]), dtype=torch.int32, device=dev)
    cursors = torch.empty(plane_ids.numel(), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().huffdecode_selfsync_launch(
            words.data_ptr(), word_off.data_ptr(), plane_ids.data_ptr(), counts.data_ptr(),
            out_off.data_ptr(), luts.data_ptr(), lut_bits, plane_ids.numel(),
            _ptr(sync_off), sync_every, seg_bits, _ptr(out), cursors.data_ptr(), _ptr(sync),
            _ptr(rounds), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("huffdecode", rc, f"{fn.__name__} launch")
    _build.count_launch(fn)
    return cursors, sync


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
    decode as parallel sub-streams; without them, by the
    self-synchronising decode (:func:`huffdecode_serial`).  Symbols and
    cursors are the same either way.

    The caller guarantees the index arrays are in range (the feed builds
    them from a validated container): ``plane_ids < P``,
    ``out_off[c] + counts[c] <= N``, ``word_off`` nondecreasing within
    ``[0, W]`` and ``sync_off`` as :func:`sync_offsets` gives it.  The
    payload bits themselves may be anything.
    """
    if (sync is None) != (sync_off is None):
        raise ValueError("huffdecode: pass sync and sync_off together")
    if out is None:
        raise ValueError("huffdecode: huffdecode_chunks needs out")
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
    *,
    seg_bits: int = SEG_BITS,
    rounds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The decode without an index: the self-synchronising kernel writes
    every chunk's symbols into ``out``; returns the final cursors.

    ``seg_bits`` (>= 16) sets the segments' length; ``rounds`` (int32[C],
    optional) receives each chunk's synchronisation rounds after the first
    pass.  Neither changes a symbol or a cursor."""
    if out is None:
        raise ValueError("huffdecode: huffdecode_serial needs out")
    return _selfsync(huffdecode_serial, words, word_off, plane_ids, counts, out_off, luts, out,
                     None, SYNC_EVERY, seg_bits, rounds)[0]


huffdecode_serial.launches = 0


def huffdecode_index(
    words: torch.Tensor,
    word_off: torch.Tensor,
    plane_ids: torch.Tensor,
    counts: torch.Tensor,
    out_off: torch.Tensor,
    luts: torch.Tensor,
    out: Optional[torch.Tensor],
    sync_off: torch.Tensor,
    sync_every: int = SYNC_EVERY,
    *,
    seg_bits: int = SEG_BITS,
    rounds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The self-synchronising decode writing the sync index (and the
    symbols into ``out`` unless it is None); returns ``(cursors, sync)``.
    ``sync`` is allocated here (``sync_off[-1]`` entries, read back to the
    host once).  ``seg_bits`` and ``rounds`` as in
    :func:`huffdecode_serial`."""
    return _selfsync(huffdecode_index, words, word_off, plane_ids, counts, out_off, luts, out,
                     sync_off, sync_every, seg_bits, rounds)


huffdecode_index.launches = 0


def huffdecode_chain(
    words: torch.Tensor,
    word_off: torch.Tensor,
    plane_ids: torch.Tensor,
    counts: torch.Tensor,
    out_off: torch.Tensor,
    luts: torch.Tensor,
    out: torch.Tensor,
    sync_off: Optional[torch.Tensor] = None,
    sync_every: int = SYNC_EVERY,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The first design, one thread walking each chunk: symbols into
    ``out`` and, with ``sync_off``, the index; returns ``(cursors, sync)``.
    No path of the package runs it: it is the baseline the measurements
    time beside :func:`huffdecode_serial` and :func:`huffdecode_index`."""
    lut_bits = _check_args(words, word_off, plane_ids, counts, out_off, luts, out)
    if out is None:
        raise ValueError("huffdecode: huffdecode_chain needs out")
    if sync_off is not None:
        _check_sync(words, plane_ids, sync_off, None, sync_every)
    dev = words.device
    if dev.type == "cpu":
        return huffdecode_chain_plain(words, word_off, plane_ids, counts, out_off, luts, out,
                                      sync_off, sync_every)
    if dev.type != "cuda":
        raise ValueError(f"huffdecode: unsupported device {dev}")
    sync = None
    if sync_off is not None:
        sync = torch.empty(int(sync_off[-1]), dtype=torch.int32, device=dev)
    cursors = torch.empty(plane_ids.numel(), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().huffdecode_chain_launch(
            words.data_ptr(), word_off.data_ptr(), plane_ids.data_ptr(), counts.data_ptr(),
            out_off.data_ptr(), luts.data_ptr(), lut_bits, plane_ids.numel(), out.data_ptr(),
            cursors.data_ptr(), _ptr(sync_off), _ptr(sync), sync_every,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("huffdecode", rc, "huffdecode_chain launch")
    _build.count_launch(huffdecode_chain)
    return cursors, sync


huffdecode_chain.launches = 0


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


def _sat(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, max=2**31 - 1).to(torch.int32)


def _segmented_exclusive(x: torch.Tensor, first: torch.Tensor, group: torch.Tensor):
    """Exclusive sum of ``x`` within each group of consecutive lanes
    (``group`` each lane's group, ``first`` each group's first lane)."""
    excl = torch.cumsum(x, 0) - x
    if not excl.numel():
        return excl
    return excl - excl[first.clamp(max=excl.numel() - 1)][group]


def huffdecode_selfsync_plain(
    words: torch.Tensor,
    word_off: torch.Tensor,
    plane_ids: torch.Tensor,
    counts: torch.Tensor,
    out_off: torch.Tensor,
    luts: torch.Tensor,
    out: Optional[torch.Tensor],
    sync_off: Optional[torch.Tensor] = None,
    sync_every: int = SYNC_EVERY,
    seg_bits: int = SEG_BITS,
    rounds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch self-synchronising decode, the kernel's algorithm with
    every segment of every chunk a lane in lockstep: each segment walks
    from a guessed start to its end; segments restart from their
    predecessor's end (``rounds`` gets each chunk's rounds) until nothing
    changes; ``torch.cumsum`` of the counts places them; they decode again,
    writing symbols into ``out`` (unless None) and the index at
    ``sync_off`` (when given); past the words or a stall the constant tail
    is written in closed form.  Returns ``(cursors, sync)``."""
    _check_args(words, word_off, plane_ids, counts, out_off, luts, out)
    dev = words.device
    c = plane_ids.numel()
    w, start, nw, row, lut, shift = _lanes(words, word_off, plane_ids, luts)
    cnt = counts.to(torch.int64)
    bits = 32 * nw
    nseg = (bits + seg_bits - 1) // seg_bits
    chunk = torch.repeat_interleave(torch.arange(c, device=dev), nseg)
    first_seg = torch.cumsum(nseg, 0) - nseg
    k = torch.arange(chunk.numel(), device=dev) - first_seg[chunk]
    lo = k * seg_bits
    hi = torch.minimum(lo + seg_bits, bits[chunk])
    s, n, r = start[chunk], nw[chunk], row[chunk]

    def walk(ids, pos):
        """Lanes ``ids`` from ``pos`` to their ends: (cursor, count, stalled)."""
        pos = pos.clone()
        steps = torch.zeros_like(pos)
        stalled = torch.zeros(pos.numel(), dtype=torch.bool, device=dev)
        live = torch.nonzero(pos < hi[ids]).squeeze(1)
        while live.numel():
            j = ids[live]
            _, length = _step(w, s[j], n[j], r[j], lut, shift, pos[live])
            stop = length == 0
            stalled[live[stop]] = True
            go = live[~stop]
            pos[go] += length[~stop]
            steps[go] += 1
            live = go[pos[go] < hi[ids[go]]]
        return pos, steps, stalled

    # phase 1: walk from the guesses, then restart until nothing changes
    lanes = torch.arange(chunk.numel(), device=dev)
    st = lo.clone()
    end, seg_n, stalled = walk(lanes, st)
    n_rounds = torch.zeros(c, dtype=torch.int64, device=dev)
    prev = (lanes - 1).clamp(min=0)
    for _ in range(int(nseg.max()) if c else 0):       # the fixpoint takes < nseg rounds
        want = torch.where((k > 0) & ~stalled[prev], end[prev], st)
        moved = torch.nonzero(want != st).squeeze(1)
        if not moved.numel():
            break
        st[moved] = want[moved]
        end[moved], seg_n[moved], stalled[moved] = walk(moved, st[moved])
        n_rounds[torch.unique(chunk[moved])] += 1
    if rounds is not None:
        rounds.copy_(n_rounds.to(torch.int32))

    # phase 2: segments before a chunk's first stall, placed by a scan
    reach = _segmented_exclusive(stalled.to(torch.int64), first_seg, chunk) == 0
    seg_n = torch.where(reach, seg_n, 0)
    first = _segmented_exclusive(seg_n, first_seg, chunk)
    tail_first = torch.zeros(c, dtype=torch.int64, device=dev).index_add_(0, chunk, seg_n)
    # the tail starts at the stall, else where the last segment ends
    tail_pos = torch.zeros(c, dtype=torch.int64, device=dev)
    has = nseg > 0
    tail_pos[has] = end[(first_seg + nseg - 1)[has]]
    stop = reach & stalled
    tail_pos[chunk[stop]] = end[stop]
    sym_t, len_t = _step(w, start, nw, row, lut, shift, tail_pos)

    sync = None
    if sync_off is not None:
        sync = torch.zeros(int(sync_off[-1]), dtype=torch.int32, device=dev)
    final = torch.zeros(c, dtype=torch.int64, device=dev)
    todo = torch.clamp(torch.minimum(seg_n, cnt[chunk] - first), min=0)
    live = torch.nonzero(todo > 0).squeeze(1)
    pos = st[live]
    t = 0
    while live.numel():
        j = chunk[live]
        i = first[live] + t
        sym, length = _step(w, s[live], n[live], r[live], lut, shift, pos)
        if out is not None:
            out[out_off[j] + i] = sym
        if sync is not None:
            at = i % sync_every == 0
            sync[sync_off[j[at]] + i[at] // sync_every] = _sat(pos[at])
        pos = pos + length
        last = i + 1 == cnt[j]
        final[j[last]] = pos[last]
        t += 1
        keep = todo[live] > t
        live, pos = live[keep], pos[keep]

    # the closed-form tail, symbols tail_first .. count-1
    extra = torch.clamp(cnt - tail_first, min=0)
    tail = torch.nonzero(extra).squeeze(1)
    final[tail] = tail_pos[tail] + extra[tail] * len_t[tail]
    if out is not None and tail.numel():
        m = extra[tail]
        which = torch.repeat_interleave(tail, m)
        idx = torch.arange(int(m.sum()), device=dev) - torch.repeat_interleave(
            torch.cumsum(m, 0) - m, m)
        out[out_off[which] + tail_first[which] + idx] = sym_t[which]
    if sync is not None and tail.numel():
        q0 = (tail_first[tail] + sync_every - 1) // sync_every
        q1 = (cnt[tail] + sync_every - 1) // sync_every
        m = torch.clamp(q1 - q0, min=0)
        which = torch.repeat_interleave(tail, m)
        q = torch.arange(int(m.sum()), device=dev) - torch.repeat_interleave(
            torch.cumsum(m, 0) - m, m) + torch.repeat_interleave(q0, m)
        sync[sync_off[which] + q] = _sat(
            tail_pos[which] + (q * sync_every - tail_first[which]) * len_t[which])
    return _sat(final), sync


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
    """Plain PyTorch K1 decode.  Without an index: the self-synchronising
    decode (:func:`huffdecode_selfsync_plain`).  With ``sync``/``sync_off``:
    every sub-stream of every chunk in lockstep for ``sync_every`` steps,
    as the sync kernel cuts them."""
    _check_args(words, word_off, plane_ids, counts, out_off, luts, out)
    if (sync is None) != (sync_off is None):
        raise ValueError("huffdecode: pass sync and sync_off together")
    if sync is None:
        return huffdecode_selfsync_plain(words, word_off, plane_ids, counts, out_off, luts,
                                         out)[0]
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
    out: Optional[torch.Tensor],
    sync_off: torch.Tensor,
    sync_every: int = SYNC_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch index form: the self-synchronising decode writing the
    index (and the symbols unless ``out`` is None)."""
    _check_sync(words, plane_ids, sync_off, None, sync_every)
    return huffdecode_selfsync_plain(words, word_off, plane_ids, counts, out_off, luts, out,
                                     sync_off, sync_every)


def huffdecode_chain_plain(
    words: torch.Tensor,
    word_off: torch.Tensor,
    plane_ids: torch.Tensor,
    counts: torch.Tensor,
    out_off: torch.Tensor,
    luts: torch.Tensor,
    out: torch.Tensor,
    sync_off: Optional[torch.Tensor] = None,
    sync_every: int = SYNC_EVERY,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch chain: one symbol of every live chunk a step, serial
    within a chunk, recording each chunk's cursor at every multiple of
    ``sync_every`` when ``sync_off`` is given."""
    _check_args(words, word_off, plane_ids, counts, out_off, luts, out)
    if sync_off is not None:
        _check_sync(words, plane_ids, sync_off, None, sync_every)
    return _serial_plain(words, word_off, plane_ids, counts, out_off, luts, out,
                         sync_off, sync_every)
