"""Canonical, length-limited Huffman codec over byte alphabets.

ZipNN drops the LZ stage entirely and entropy-codes each byte-group plane
with Huffman codes (paper §3.1, "Huffman only Compression").  This module is
our independent implementation:

* code-length assignment via **package-merge** (optimal length-limited codes,
  max length 15 → every code fits a uint16 and any symbol spans ≤ 2 bytes of
  output), matching DEFLATE/zstd table constraints;
* **canonical** code assignment so the table serializes as 256 4-bit lengths
  (128 bytes);
* a **vectorized two-pass encoder** (lengths → exclusive prefix sum of bit
  offsets → scatter code bits → packbits).  This is the same formulation the
  device bit-pack kernel uses: a device has no serial bit I/O,
  so the parallel prefix-sum form is the hardware-appropriate one;
* a **lockstep chunk-parallel decoder**: all chunks of a stream decode in
  SIMD lockstep, one symbol per iteration across every chunk.  This mirrors
  the paper's §5.1 design where the per-chunk metadata map makes
  decompression embarrassingly parallel.
"""

from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "MAX_CODE_LEN",
    "code_lengths",
    "canonical_codes",
    "pack_table",
    "unpack_table",
    "encode",
    "encode_chunks",
    "decode",
    "decode_many",
    "estimate_encoded_bits",
]

MAX_CODE_LEN = 15


# ---------------------------------------------------------------------------
# Code construction
# ---------------------------------------------------------------------------

def _plain_huffman_lengths(freqs: np.ndarray) -> np.ndarray:
    """Unlimited-depth Huffman code lengths via the classic heap algorithm."""
    lens = np.zeros(256, dtype=np.int64)
    syms = np.nonzero(freqs)[0]
    if syms.size == 0:
        return lens
    if syms.size == 1:
        lens[syms[0]] = 1
        return lens
    # heap of (weight, tiebreak, [symbols])
    heap: List[Tuple[int, int, List[int]]] = [
        (int(freqs[s]), int(s), [int(s)]) for s in syms
    ]
    heapq.heapify(heap)
    tie = 256
    while len(heap) > 1:
        w1, _, s1 = heapq.heappop(heap)
        w2, _, s2 = heapq.heappop(heap)
        for s in s1:
            lens[s] += 1
        for s in s2:
            lens[s] += 1
        heapq.heappush(heap, (w1 + w2, tie, s1 + s2))
        tie += 1
    return lens


def _kraft_fixup(lens: np.ndarray, max_len: int) -> np.ndarray:
    """Clamp code lengths to ``max_len`` and restore the Kraft equality.

    Standard zlib-style adjustment: clamp, then while the Kraft sum exceeds
    one, deepen the shallowest clamp-violating leaves; finally shorten codes
    while slack remains (keeps optimality loss negligible, guarantees a
    decodable prefix code).
    """
    lens = lens.copy()
    over = lens > max_len
    if not over.any():
        return lens
    lens[over] = max_len
    # Kraft sum in units of 2^-max_len.
    unit = 1 << max_len
    used = np.nonzero(lens)[0]
    kraft = int(sum(unit >> int(lens[s]) for s in used))
    # Deepen nodes (increase length ⇒ decrease Kraft contribution).
    order = sorted(used, key=lambda s: (lens[s], s), reverse=True)
    i = 0
    while kraft > unit:
        s = order[i % len(order)]
        if lens[s] < max_len:
            kraft -= (unit >> int(lens[s])) - (unit >> int(lens[s] + 1))
            lens[s] += 1
        i += 1
    # Tighten: give back slack to the most frequent long codes.
    for s in sorted(used, key=lambda s: (-lens[s], s)):
        while lens[s] > 1 and kraft + (unit >> int(lens[s])) <= unit:
            kraft += unit >> int(lens[s])
            lens[s] -= 1
    return lens


def code_lengths(freqs: np.ndarray, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Length-limited Huffman code lengths for a 256-symbol alphabet."""
    freqs = np.asarray(freqs, dtype=np.int64)
    if freqs.shape != (256,):
        raise ValueError("freqs must have shape (256,)")
    lens = _plain_huffman_lengths(freqs)
    if lens.max(initial=0) > max_len:
        lens = _kraft_fixup(lens, max_len)
    return lens


def canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Canonical code values (uint16) for given lengths: sorted by (len, sym)."""
    lens = np.asarray(lens, dtype=np.int64)
    codes = np.zeros(256, dtype=np.uint16)
    code = 0
    prev_len = 0
    order = sorted(np.nonzero(lens)[0], key=lambda s: (lens[s], s))
    for s in order:
        code <<= int(lens[s]) - prev_len
        codes[s] = code
        code += 1
        prev_len = int(lens[s])
    return codes


def pack_table(lens: np.ndarray) -> bytes:
    """Serialize 256 code lengths (each ≤ 15) as 128 bytes of nibbles."""
    lens = np.asarray(lens, dtype=np.uint8)
    return ((lens[0::2] << 4) | lens[1::2]).tobytes()


def unpack_table(blob: bytes) -> np.ndarray:
    b = np.frombuffer(blob, dtype=np.uint8)
    lens = np.empty(256, dtype=np.int64)
    lens[0::2] = b >> 4
    lens[1::2] = b & 0xF
    return lens


# ---------------------------------------------------------------------------
# Encoder (vectorized two-pass)
# ---------------------------------------------------------------------------

def encode_chunks(
    data: np.ndarray, chunk_counts: np.ndarray, lens: np.ndarray, codes: np.ndarray
) -> List[bytes]:
    """Encode many chunks of one stream in a single vectorized pass.

    ``data`` is the concatenation of the chunks (uint8), ``chunk_counts``
    their symbol counts.  Every chunk's bitstream is byte-aligned so chunks
    stay independently decodable (the §5.1 parallel-decode requirement).

    Two-pass parallel formulation (also the device bit-pack schedule):
      1. gather code lengths, exclusive prefix-sum → per-symbol bit offsets
         (with per-chunk byte-aligned bases);
      2. scatter code bits.  Symbols are bucketed by code length so the
         scatter work is proportional to *total output bits* (≈ entropy),
         not ``N × max_len``.
    """
    data = np.ascontiguousarray(data, dtype=np.uint8)
    chunk_counts = np.asarray(chunk_counts, dtype=np.int64)
    n_chunks = chunk_counts.size
    if data.size == 0:
        return [b""] * n_chunks

    sym_lens = lens[data]                        # (N,)
    csum = np.cumsum(sym_lens)
    ends = np.cumsum(chunk_counts)               # symbol-index chunk ends
    chunk_csum_end = csum[ends - 1]
    base_csum = np.concatenate([[0], chunk_csum_end[:-1]])
    chunk_bits = np.diff(np.concatenate([[0], chunk_csum_end]))
    chunk_nbytes = (chunk_bits + 7) >> 3
    chunk_bit_base = 8 * np.concatenate([[0], np.cumsum(chunk_nbytes)])[:-1]

    chunk_of = np.repeat(np.arange(n_chunks), chunk_counts)
    starts = (chunk_bit_base[chunk_of] + (csum - sym_lens - base_csum[chunk_of])).astype(
        np.int64
    )
    total_bytes = int(chunk_nbytes.sum())
    bits = np.zeros(total_bytes * 8, dtype=np.uint8)
    sym_codes = codes[data].astype(np.uint32)
    max_l = int(sym_lens.max())
    for L in range(1, max_l + 1):                # bucket per code length
        idx = np.flatnonzero(sym_lens == L)
        if idx.size == 0:
            continue
        st = starts[idx]
        cd = sym_codes[idx]
        for k in range(L):
            bits[st + k] = ((cd >> (L - 1 - k)) & 1).astype(np.uint8)
    packed = np.packbits(bits)
    offs = np.concatenate([[0], np.cumsum(chunk_nbytes)])
    return [packed[offs[i] : offs[i + 1]].tobytes() for i in range(n_chunks)]


def encode(data: np.ndarray, lens: np.ndarray, codes: np.ndarray) -> bytes:
    """Encode one uint8 stream with a canonical table. Byte-aligned output."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.size == 0:
        return b""
    return encode_chunks(data, np.asarray([data.size]), lens, codes)[0]


def estimate_encoded_bits(freqs: np.ndarray, lens: np.ndarray) -> int:
    """Exact payload size in bits for a histogram under a length table."""
    return int(np.dot(np.asarray(freqs, dtype=np.int64), np.asarray(lens, dtype=np.int64)))


# ---------------------------------------------------------------------------
# Decoder (lockstep chunk-parallel)
# ---------------------------------------------------------------------------

def _build_lut(lens: np.ndarray, codes: np.ndarray, lut_bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """(2**lut_bits,) symbol and length lookup tables for canonical codes."""
    lut_sym = np.zeros(1 << lut_bits, dtype=np.uint8)
    lut_len = np.zeros(1 << lut_bits, dtype=np.uint8)
    for s in np.nonzero(lens)[0]:
        l = int(lens[s])
        prefix = int(codes[s]) << (lut_bits - l)
        span = 1 << (lut_bits - l)
        lut_sym[prefix : prefix + span] = s
        lut_len[prefix : prefix + span] = l
    return lut_sym, lut_len


def decode(payload: bytes, n_symbols: int, lens: np.ndarray) -> np.ndarray:
    """Decode one stream (convenience wrapper over :func:`decode_many`)."""
    return decode_many([payload], [n_symbols], lens)[0]


def decode_many(
    payloads: Sequence[bytes], n_symbols: Sequence[int], lens: np.ndarray
) -> List[np.ndarray]:
    """Decode many independent chunks *in lockstep*.

    All chunks share one canonical table (per-plane tables in the container
    format).  Iteration ``i`` decodes symbol ``i`` of every still-active
    chunk with vectorized gathers — the SIMD expression of the paper's
    chunk-level parallelism, and the exact schedule of the device decode path
    (grid over chunks).
    """
    lens = np.asarray(lens, dtype=np.int64)
    codes = canonical_codes(lens)
    max_l = int(lens.max(initial=1))
    lut_sym, lut_len = _build_lut(lens, codes, max_l)
    # Fused 16-bit LUT: one gather yields (symbol, length).
    lut16 = (lut_sym.astype(np.uint16) << 8) | lut_len.astype(np.uint16)

    counts = np.asarray(list(n_symbols), dtype=np.int64)
    n_chunks = len(payloads)
    if n_chunks == 0:
        return []
    sizes = np.asarray([len(p) for p in payloads], dtype=np.int64)
    if np.any((counts > 0) & (sizes == 0)):
        raise ValueError("corrupt Huffman payload: empty payload for a non-empty chunk")
    starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    buf = np.frombuffer(b"".join(payloads) + b"\x00\x00\x00", dtype=np.uint8)
    # Precompute a 24-bit sliding window at every byte offset (3 vector
    # passes) so the inner loop does a single gather per chunk per symbol.
    b32 = buf.astype(np.uint32)
    buf24 = (b32[:-2] << 16) | (b32[1:-1] << 8) | b32[2:]

    max_count = int(counts.max(initial=0))
    out = np.zeros((n_chunks, max_count), dtype=np.uint8)
    bitpos = (starts * 8).astype(np.int64)        # absolute bit cursor
    shift_base = np.uint32(24 - max_l)
    mask = np.uint32((1 << max_l) - 1)
    # Lockstep over symbols; chunks that finish early keep decoding garbage
    # into columns that get trimmed (cheaper than re-masking each iteration).
    # Their cursors are clamped to the global buffer end: a *live* cursor is
    # always strictly below it, so the clamp never perturbs real decoding.
    total_bits = (buf.size - 3) * 8
    full = int(counts.min(initial=0))
    final = (starts * 8).astype(np.int64)         # cursor at each chunk's end
    for i in range(max_count):
        window = (buf24[bitpos >> 3] >> (shift_base - (bitpos & 7).astype(np.uint32))) & mask
        v = lut16[window]
        out[:, i] = (v >> 8).astype(np.uint8)
        bitpos += v & 0xFF
        done = counts == i + 1
        if done.any():
            final[done] = bitpos[done]
        if i >= full:                             # only finished cursors move
            np.minimum(bitpos, total_bits, out=bitpos)
    # Integrity: a valid chunk's cursor stops inside its own final byte (the
    # encoder byte-aligns every chunk, so 0-7 pad bits of slack).  Corrupt
    # payloads, wrong tables, or a tampered symbol count either stall the
    # cursor (invalid prefix: length 0) or run it past the chunk — both land
    # outside [0, 8) slack and are rejected instead of yielding wrong bytes.
    used = final - starts * 8
    slack = sizes * 8 - used
    if np.any((slack < 0) | ((slack >= 8) & (counts > 0))):
        raise ValueError(
            "corrupt Huffman payload: bit cursor did not land on the "
            "chunk's final byte"
        )
    # Every encoder (host packbits and the device bit-pack kernel alike)
    # zeroes the 0-7 pad bits of a chunk's final byte, so nonzero pad is
    # corruption even when the cursor lands correctly — matching the device
    # kernel's masked-tail semantics instead of silently accepting garbage.
    live = counts > 0
    last = buf[np.clip(starts + sizes - 1, 0, buf.size - 1)]
    pad_mask = (np.left_shift(1, np.clip(slack, 0, 7)) - 1).astype(np.uint8)
    if np.any(live & (slack > 0) & ((last & pad_mask) != 0)):
        raise ValueError(
            "corrupt Huffman payload: nonzero pad bits in the chunk's "
            "final byte"
        )
    return [out[c, : int(counts[c])].copy() for c in range(n_chunks)]
