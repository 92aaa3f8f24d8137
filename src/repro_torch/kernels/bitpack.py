"""Kernel K7: multi-table canonical-Huffman bit-packing of whole chunks.

:func:`bitpack_encode_chunks` launches the CUDA kernel in
``csrc/bitpack.cu`` on CUDA tensors and runs
:func:`bitpack_encode_chunks_plain`, its plain PyTorch version, on CPU
tensors.  It raises on any other device; there is no fallback from the
kernel to the plain version.

Inputs (every tensor on one device, contiguous):

* ``syms``        uint8[C * chunk_syms] — C chunks back to back (a final
  partial chunk is zero-padded by the caller);
* ``plane_ids``   int32[C] — the table row each chunk packs under;
* ``len_tables``  int32[P, 256] — canonical code lengths, 0..15;
* ``code_tables`` int32[P, 256] — canonical codes (only the low ``len``
  bits of each are read).

Returns ``(words, nbits)``: ``words`` int32[C, chunk_syms / 4] holding
the uint32 bits of each chunk's stream (bit ``j`` of a chunk at bit
``31 - (j & 31)`` of word ``j >> 5``, so the words' big-endian bytes are
the host encoder's ``np.packbits`` stream; words the codes do not reach
are zero), and ``nbits`` int32[C], the bits every chunk's codes take.  A
chunk whose codes take more than its raw size (``8 * chunk_syms`` bits)
keeps only its first ``chunk_syms / 4`` words but reports its full bit
count: the host stores such a chunk raw.  Both equal, bit for bit, what
the reference's ``bitpack_encode_chunks_multi`` returns.

On a card one call runs one CUDA kernel, a thread block for each segment
of :data:`SEGMENT_SYMS` symbols of a chunk.  It reads nothing back to the
host: the kernel checks the table on the card, and a chunk whose plane id
names no row, or whose row holds a length outside 0..15, comes back with
``nbits = -1`` (its words zero); the callers raise ``ValueError`` for it.
``nbits = -2`` marks a chunk whose segments could not be placed (the
kernel's safety net against a stalled look-back; it does not occur).  The
plain version checks the lengths itself and raises ``ValueError``.

Kernel K8, :func:`bitpack_encode_chunks_single`, is the same kernel
launched with one table for every chunk, the counterpart of the
reference's single-table ``bitpack_encode_chunks``; it counts its own
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

__all__ = [
    "MAXL",
    "SEGMENT_SYMS",
    "bitpack_encode_chunks",
    "bitpack_encode_chunks_plain",
    "bitpack_encode_chunks_single",
    "bitpack_encode_chunks_single_plain",
    "segments",
]

MAXL = 15                      # the encoder's length-limited code lengths
SEGMENT_SYMS = 8192            # symbols a thread block packs (SEG in csrc/bitpack.cu)


def _check_args(syms, plane_ids, len_tables, code_tables, chunk_syms) -> int:
    dev = syms.device
    want = (
        ("syms", syms, torch.uint8, 1),
        ("plane_ids", plane_ids, torch.int32, 1),
        ("len_tables", len_tables, torch.int32, 2),
        ("code_tables", code_tables, torch.int32, 2),
    )
    for name, t, dtype, ndim in want:
        if t.device != dev:
            raise ValueError(f"bitpack: {name} is on {t.device}, syms on {dev}")
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(
                f"bitpack: {name} must be a contiguous {ndim}-d {dtype} "
                f"tensor, got {t.dtype} of shape {tuple(t.shape)}"
            )
    if chunk_syms <= 0 or chunk_syms % 4:
        raise ValueError(f"bitpack: chunk_syms {chunk_syms} is not a positive multiple of 4")
    if syms.numel() % chunk_syms:
        raise ValueError("bitpack: pad the symbols to whole chunks")
    c = syms.numel() // chunk_syms
    if plane_ids.numel() != c:
        raise ValueError(f"bitpack: {plane_ids.numel()} plane ids for {c} chunks")
    if len_tables.shape != code_tables.shape or len_tables.shape[1:] != (256,):
        raise ValueError("bitpack: tables must both be (P, 256)")
    return c


def _check_lengths(len_tables) -> None:
    """The plain version's table check.  It reads the table's extremes, so
    on a card it waits for the device; the kernel checks on the card
    instead and flags the chunk (``nbits = -1``)."""
    if len_tables.numel() and not 0 <= int(len_tables.min()) <= int(len_tables.max()) <= MAXL:
        raise ValueError(f"bitpack: code lengths must lie in 0..{MAXL}")


@functools.cache
def _launcher():
    fn = _build.load("bitpack").bitpack_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def segments(chunk_syms: int) -> int:
    """Thread blocks (segments of :data:`SEGMENT_SYMS` symbols) per chunk."""
    return -(-chunk_syms // SEGMENT_SYMS)


def bitpack_encode_chunks(
    syms: torch.Tensor,
    plane_ids: torch.Tensor,
    len_tables: torch.Tensor,
    code_tables: torch.Tensor,
    *,
    chunk_syms: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack chunk ``i`` of ``syms`` under table row ``plane_ids[i]``;
    returns (int32 words ``(C, chunk_syms / 4)``, int32 bit counts ``(C,)``)."""
    c = _check_args(syms, plane_ids, len_tables, code_tables, chunk_syms)
    if syms.device.type == "cpu":
        return bitpack_encode_chunks_plain(
            syms, plane_ids, len_tables, code_tables, chunk_syms=chunk_syms
        )
    return _launch(bitpack_encode_chunks, c, syms, plane_ids, len_tables, code_tables, chunk_syms)


bitpack_encode_chunks.launches = 0


def _launch(fn, c, syms, plane_ids, len_tables, code_tables, chunk_syms):
    """Launch the kernel for ``c`` checked chunks and count it on ``fn``."""
    dev = syms.device
    if dev.type != "cuda":
        raise ValueError(f"bitpack: unsupported device {dev}")
    if syms.data_ptr() % 4:
        raise ValueError("bitpack: syms must start on a 4-byte boundary")
    words = torch.zeros((c, chunk_syms // 4), dtype=torch.int32, device=dev)
    nbits = torch.empty(c, dtype=torch.int32, device=dev)
    if c == 0:
        return words, nbits
    # each segment's published bit count, and the ticket counter last
    status = torch.zeros(c * segments(chunk_syms) + 1, dtype=torch.int64, device=dev)
    rc = _launcher()(
        syms.data_ptr(), plane_ids.data_ptr(), len_tables.data_ptr(),
        code_tables.data_ptr(), len_tables.shape[0], status.data_ptr(),
        words.data_ptr(), nbits.data_ptr(), c, chunk_syms,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("bitpack", rc, f"{fn.__name__} launch")
    _build.count_launch(fn)
    return words, nbits


def bitpack_encode_chunks_plain(
    syms: torch.Tensor,
    plane_ids: torch.Tensor,
    len_tables: torch.Tensor,
    code_tables: torch.Tensor,
    *,
    chunk_syms: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K7 in int64 lanes: a cumulative sum of the lengths
    places every code, and each code is added (its bits overlap no other
    code's, so adding is OR) into the one or two words it spans."""
    c = _check_args(syms, plane_ids, len_tables, code_tables, chunk_syms)
    _check_lengths(len_tables)
    dev = syms.device
    cap = chunk_syms // 4
    s = syms.view(c, chunk_syms).to(torch.int64)
    pid = plane_ids.to(torch.int64).view(c, 1)
    lens = len_tables.to(torch.int64)[pid, s]
    codes = code_tables.to(torch.int64)[pid, s] & ((1 << lens) - 1)
    ends = torch.cumsum(lens, dim=1)
    starts = ends - lens
    w, o = starts >> 5, starts & 31
    spill = (o + lens - 32).clamp(min=0)          # bits that go to word w + 1
    first = (codes >> spill) << (32 - o - (lens - spill))
    second = (codes & ((1 << spill) - 1)) << (32 - spill)
    row = torch.arange(c, device=dev).view(c, 1) * cap
    out = torch.zeros(c * cap, dtype=torch.int64, device=dev)
    keep = w < cap
    out.index_add_(0, (row + w)[keep], first[keep])
    keep = (spill > 0) & (w + 1 < cap)
    out.index_add_(0, (row + w + 1)[keep], second[keep])
    # narrowing to int32 keeps the low 32 bits: the uint32 word's bits
    return out.to(torch.int32).view(c, cap), ends[:, -1].to(torch.int32)


def _single_args(syms, len_table, code_table, chunk_syms):
    """K7's arguments for one table: every chunk on row 0."""
    if len_table.shape != (256,) or code_table.shape != (256,):
        raise ValueError("bitpack: the single table must be two (256,) tensors")
    c = syms.numel() // chunk_syms if chunk_syms > 0 else 0
    plane_ids = torch.zeros(c, dtype=torch.int32, device=syms.device)
    return syms, plane_ids, len_table.view(1, 256), code_table.view(1, 256)


def bitpack_encode_chunks_single(
    syms: torch.Tensor,
    len_table: torch.Tensor,
    code_table: torch.Tensor,
    *,
    chunk_syms: int = 1 << 13,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K8: pack every chunk of ``syms`` under one table (int32
    ``(256,)`` lengths and codes); returns (int32 words ``(C, chunk_syms /
    4)``, int32 bit counts ``(C,)``).

    The counterpart of the reference's ``repro.kernels.bitpack.
    bitpack_encode_chunks``, which shares its kernel body with the
    per-chunk-table ``bitpack_encode_chunks_multi``.  The port's
    :func:`bitpack_encode_chunks` is the counterpart of ``_multi``; this
    launches its kernel with one table row.
    """
    args = _single_args(syms, len_table, code_table, chunk_syms)
    c = _check_args(*args, chunk_syms)
    if syms.device.type == "cpu":
        return bitpack_encode_chunks_plain(*args, chunk_syms=chunk_syms)
    return _launch(bitpack_encode_chunks_single, c, *args, chunk_syms)


bitpack_encode_chunks_single.launches = 0


def bitpack_encode_chunks_single_plain(
    syms: torch.Tensor,
    len_table: torch.Tensor,
    code_table: torch.Tensor,
    *,
    chunk_syms: int = 1 << 13,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K8: the plain K7 with every chunk on one table row."""
    args = _single_args(syms, len_table, code_table, chunk_syms)
    return bitpack_encode_chunks_plain(*args, chunk_syms=chunk_syms)
