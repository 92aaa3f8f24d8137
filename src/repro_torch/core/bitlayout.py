"""Floating-point bit layouts and the exponent-extraction transform.

ZipNN's first key mechanism (paper §3.1, Fig. 3) is *exponent extraction*:
the exponent bits of each parameter are separated from the sign/fraction
bits so that the highly-skewed exponent distribution can be entropy coded
on its own stream.

For the IEEE-ish layouts used by models::

    FP32:  [ s | e e e e e e e e | f*23 ]          (1, 8, 23)
    BF16:  [ s | e e e e e e e e | f*7  ]          (1, 8, 7)
    FP16:  [ s | e e e e e | f*10 ]                (1, 5, 10)

the exponent does not live on a byte boundary — the sign bit sits above it.
We therefore apply a *rotate-left-by-1* to the underlying uint before byte
splitting.  After rotation the most-significant byte of a BF16/FP32 value is
the pure 8-bit exponent and the sign bit is appended as the LSB of the last
byte.  The rotation is a bijection on the uint domain, hence lossless, and
costs one shift+or per element.

Byte grouping (paper §3.2, Fig. 5) then splits the (rotated) values into
per-byte planes: plane 0 = exponent byte, planes 1..k = fraction bytes.
Each plane is compressed independently.

**Sub-byte layouts (fp8).**  For one-byte floats the exponent field does
not fill a byte, so whole-byte grouping would leave the skewed exponent
bits interleaved with sign/fraction noise in a single plane — order-0
entropy coding gains nothing from a plain rotation (it only permutes the
byte histogram).  fp8 layouts therefore set ``sub_byte``: after the
rotate-left-1 (which parks the exponent at the top of the byte —
``e4m3``: ``[eeee|fffs]``, ``e5m2``: ``[eeeee|ffs]``), *element pairs*
are split at the nibble: plane 0 packs the two high nibbles
(exponent-dominated), plane 1 the two low nibbles (fraction/sign).  The
split is a bijection on byte pairs, hence lossless; bodies align to 2
bytes (``layout.align``), with an odd trailing element riding the
container's ``TAIL`` mechanism.  ``int8`` gets its own whole-byte layout
(no rotation — two's complement already clusters small magnitudes for the
order-0 histogram).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "BitLayout",
    "LAYOUTS",
    "layout_for",
    "layout_by_name",
    "to_planes",
    "from_planes",
    "exponent_view",
]


@dataclasses.dataclass(frozen=True)
class BitLayout:
    """Describes how a parameter dtype maps onto byte-group planes."""

    name: str
    itemsize: int              # bytes per parameter
    uint_dtype: np.dtype       # unsigned container dtype
    sign_bits: int
    exp_bits: int
    frac_bits: int
    rotate: bool               # apply rotate-left-1 so plane0 == exponent
    sub_byte: bool = False     # nibble-split element pairs (fp8 layouts)

    @property
    def total_bits(self) -> int:
        return 8 * self.itemsize

    @property
    def n_planes(self) -> int:
        return 2 if self.sub_byte else self.itemsize

    @property
    def align(self) -> int:
        """Plane-split granule in bytes: bodies must be a multiple of this
        (sub-byte layouts split element *pairs*, so 2 even at itemsize 1)."""
        return 2 if self.sub_byte else self.itemsize


_LAYOUT_FP32 = BitLayout("fp32", 4, np.dtype(np.uint32), 1, 8, 23, True)
_LAYOUT_BF16 = BitLayout("bf16", 2, np.dtype(np.uint16), 1, 8, 7, True)
_LAYOUT_FP16 = BitLayout("fp16", 2, np.dtype(np.uint16), 1, 5, 10, True)
_LAYOUT_FP64 = BitLayout("fp64", 8, np.dtype(np.uint64), 1, 11, 52, True)
# Integer / quantized tensors: plain byte grouping, no rotation (there is no
# exponent; paper §3: "tensors of parameters that contain integers ... hardly
# affect the model compression ratio" — we still byte-group them).
_LAYOUT_U8 = BitLayout("u8", 1, np.dtype(np.uint8), 0, 0, 8, False)
# int8 quantized tensors: identical plane geometry to u8 but carried as a
# distinct layout so corpus/bench rows and container headers name it.
_LAYOUT_I8 = BitLayout("i8", 1, np.dtype(np.uint8), 0, 0, 8, False)
_LAYOUT_I32 = BitLayout("i32", 4, np.dtype(np.uint32), 0, 0, 32, False)
_LAYOUT_I64 = BitLayout("i64", 8, np.dtype(np.uint64), 0, 0, 64, False)
_LAYOUT_U16 = BitLayout("u16", 2, np.dtype(np.uint16), 0, 0, 16, False)
# fp8 (paper-adjacent: the component-compression papers' quantized formats).
# rotate=True parks the exponent at the byte top before the nibble split.
_LAYOUT_F8E4M3 = BitLayout(
    "f8e4", 1, np.dtype(np.uint8), 1, 4, 3, True, sub_byte=True
)
_LAYOUT_F8E5M2 = BitLayout(
    "f8e5", 1, np.dtype(np.uint8), 1, 5, 2, True, sub_byte=True
)

LAYOUTS: Dict[str, BitLayout] = {
    "float32": _LAYOUT_FP32,
    "bfloat16": _LAYOUT_BF16,
    "float16": _LAYOUT_FP16,
    "float64": _LAYOUT_FP64,
    "uint8": _LAYOUT_U8,
    "int8": _LAYOUT_I8,
    "bool": _LAYOUT_U8,
    # fp8 family: same (sign, exp, frac) geometry per pair; the
    # fn/fnuz bias variants share the bit layout, which is all we touch.
    "float8_e4m3fn": _LAYOUT_F8E4M3,
    "float8_e4m3": _LAYOUT_F8E4M3,
    "float8_e4m3fnuz": _LAYOUT_F8E4M3,
    "float8_e5m2": _LAYOUT_F8E5M2,
    "float8_e5m2fnuz": _LAYOUT_F8E5M2,
    "int32": _LAYOUT_I32,
    "uint32": _LAYOUT_I32,
    "int64": _LAYOUT_I64,
    "uint64": _LAYOUT_I64,
    "int16": _LAYOUT_U16,
    "uint16": _LAYOUT_U16,
}


def layout_for(dtype_name: str) -> BitLayout:
    """Layout for a dtype name ('bfloat16', 'float32', ...)."""
    try:
        return LAYOUTS[dtype_name]
    except KeyError:
        raise ValueError(f"no ZipNN bit layout for dtype {dtype_name!r}") from None


def layout_by_name(layout_name: str) -> BitLayout:
    """Layout for a *layout* name ('bf16', 'fp32', ...) as stored in ZNN1
    container headers.  Unknown names raise ``ValueError`` — a corrupted
    header byte must surface as a clean parse error, not a StopIteration."""
    for layout in LAYOUTS.values():
        if layout.name == layout_name:
            return layout
    raise ValueError(f"unknown ZNN1 layout name {layout_name!r}")


# Rotations run segment-at-a-time into a preallocated output: whole-array
# expressions allocate multi-16MB temps (page-fault churn past the allocator
# cache), and per-segment ufuncs release the GIL so segments fan across the
# engine pool.
_ROT_SEG = 1 << 20      # elements per rotate work item


def _rot1_segmented(u: np.ndarray, bits: int, left: bool, pool) -> np.ndarray:
    out = np.empty_like(u)
    a, b = (1, bits - 1) if left else (bits - 1, 1)

    def seg(i0):
        s = u[i0 : i0 + _ROT_SEG]
        d = out[i0 : i0 + _ROT_SEG]
        np.left_shift(s, a, out=d)
        d |= s >> b

    starts = range(0, u.size, _ROT_SEG)
    if pool is not None and len(starts) > 1:
        list(pool.map(seg, starts))
    else:
        for i0 in starts:
            seg(i0)
    return out


def _rotl1(u: np.ndarray, bits: int, pool=None) -> np.ndarray:
    return _rot1_segmented(u, bits, True, pool)


def _rotr1(u: np.ndarray, bits: int, pool=None) -> np.ndarray:
    return _rot1_segmented(u, bits, False, pool)


def to_planes(
    raw: np.ndarray, layout: BitLayout, pool=None
) -> Tuple[np.ndarray, ...]:
    """Split a flat uint8 buffer of parameters into byte-group planes.

    ``raw`` is the little-endian byte view of the tensor, length divisible by
    ``layout.itemsize``.  Returns ``layout.n_planes`` uint8 arrays, plane 0
    being the (pure, if ``layout.rotate``) exponent byte — most significant
    byte after rotation — matching paper Fig. 3/Fig. 5.

    The per-plane strided gathers are independent memcpy loops (which
    release the GIL), so ``pool`` fans them across threads.
    """
    if raw.dtype != np.uint8:
        raise TypeError("to_planes expects a uint8 byte view")
    if raw.size % layout.align:
        raise ValueError(
            f"buffer of {raw.size} bytes is not a multiple of align {layout.align}"
        )
    if layout.sub_byte:
        u = raw
        if layout.rotate:
            u = _rotl1(np.ascontiguousarray(u), 8, pool)
        pairs = u.reshape(-1, 2)
        hi = ((pairs[:, 0] & 0xF0) | (pairs[:, 1] >> 4)).astype(np.uint8)
        lo = (((pairs[:, 0] & 0x0F) << 4) | (pairs[:, 1] & 0x0F)).astype(np.uint8)
        return (np.ascontiguousarray(hi), np.ascontiguousarray(lo))
    if layout.itemsize == 1:
        return (np.ascontiguousarray(raw),)
    u = raw.view(layout.uint_dtype)
    if layout.rotate:
        u = _rotl1(u, layout.total_bits, pool)
    # Big-endian byte split: plane 0 = MSB (exponent after rotation).
    # Strided views over the little-endian byte image — one memcpy per plane
    # instead of shift+mask+downcast per plane.
    bytes_le = u.view(np.uint8).reshape(-1, layout.itemsize)
    cols = [layout.itemsize - 1 - i for i in range(layout.itemsize)]
    if pool is not None:
        return tuple(
            pool.map(lambda c: np.ascontiguousarray(bytes_le[:, c]), cols)
        )
    return tuple(np.ascontiguousarray(bytes_le[:, c]) for c in cols)


def from_planes(
    planes: Tuple[np.ndarray, ...], layout: BitLayout, pool=None
) -> np.ndarray:
    """Inverse of :func:`to_planes` — returns the flat uint8 byte view.

    Each plane scatters into its own byte column of the output, so the
    per-plane writes are disjoint and safe to fan across ``pool``.
    """
    if len(planes) != layout.n_planes:
        raise ValueError(f"expected {layout.n_planes} planes, got {len(planes)}")
    if layout.sub_byte:
        hi, lo = planes
        if hi.size != lo.size:
            raise ValueError("sub-byte planes must pair 1:1")
        out = np.empty(hi.size * 2, dtype=np.uint8)
        pairs = out.reshape(-1, 2)
        pairs[:, 0] = (hi & 0xF0) | (lo >> 4)
        pairs[:, 1] = ((hi & 0x0F) << 4) | (lo & 0x0F)
        if layout.rotate:
            out = _rotr1(out, 8, pool)
        return out
    if layout.itemsize == 1:
        return np.ascontiguousarray(planes[0])
    n = planes[0].size
    bytes_le = np.empty((n, layout.itemsize), dtype=np.uint8)

    def scatter(i_p):
        i, p = i_p
        bytes_le[:, layout.itemsize - 1 - i] = p

    if pool is not None:
        list(pool.map(scatter, enumerate(planes)))
    else:
        for ip in enumerate(planes):
            scatter(ip)
    u = bytes_le.reshape(-1).view(layout.uint_dtype)
    if layout.rotate:
        u = _rotr1(u, layout.total_bits, pool)
    return u.view(np.uint8)


def exponent_view(arr: np.ndarray) -> np.ndarray:
    """Return the biased exponent of every element of a float array.

    Used by the Fig. 2 benchmark (exponent histograms) and by entropy probes.
    """
    name = arr.dtype.name
    layout = layout_for(name)
    if layout.exp_bits == 0:
        raise ValueError(f"dtype {name} has no exponent")
    u = np.ascontiguousarray(arr).view(layout.uint_dtype)
    shift = layout.frac_bits
    mask = (1 << layout.exp_bits) - 1
    return ((u >> np.asarray(shift, dtype=u.dtype)) & np.asarray(mask, dtype=u.dtype)).astype(
        np.int32
    )
