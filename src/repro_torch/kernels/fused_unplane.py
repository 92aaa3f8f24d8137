"""Kernel K2: the plane consumer — un-byte-group, inverse rotate, XOR base.

:func:`plane_consumer` launches the CUDA kernel in ``csrc/unplane.cu`` on
CUDA tensors and runs :func:`plane_consumer_plain`, its plain PyTorch
version, on CPU tensors.  It raises on any other device; there is no
fallback from the kernel to the plain version.

``planes`` are ``itemsize`` flat uint8 tensors of one length ``n`` (plane 0
the most significant byte: the exponent after the encoder's rotate-left-1).
The result is ``n`` elements of element bits, int16 for ``itemsize`` 2 and
int32 for 4 (the bits of uint16/uint32; callers view them as
bf16/fp16/fp32).  ``base``, when given, is ``n`` elements of the same
dtype, XORed in for a delta stream.  Any ``n`` works: there is no row-block
padding.

A launch takes one of three paths, decided on the host by
:func:`_unplane_plan` and counted in the wrapper's ``launches_by_path``:
``"bulk"`` (whole tiles through the kernel's pipeline of bulk copies, the
ragged remainder by 16-byte groups and then by element), ``"vector"`` (a
call too small to fill the pipeline: groups and elements) and
``"element"`` (some pointer is not 16-byte aligned: every element alone).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from . import _build

__all__ = ["ELEM_DTYPES", "PATHS", "plane_consumer", "plane_consumer_plain"]

ELEM_DTYPES = {2: torch.int16, 4: torch.int32}
PATHS = ("bulk", "vector", "element")

# The bulk pipeline's tiles (kernels/unplane_launch_sweep.py chose them on
# an H100).  A tile carries at most TILE_IN_BYTES of planes, and of base,
# into a shared-memory stage (csrc/unplane.cu holds the same bound).  A
# call is cut into whole waves of WAVE_TILES tiles for each SM, with tiles
# as large as that allows, so that every persistent block gets the same
# number of tiles, down to MIN_TILE elements a tile; a call of more than
# BIG_WAVES waves takes the largest tile (its last, partial wave is then
# a small share).  A call of fewer than VECTOR_TILES_PER_SM[itemsize]
# MIN_TILE tiles for each SM fills no pipeline: it takes the vector path
# (16-element groups), which the sweep read faster there at bf16; at fp32
# the pipeline was faster down to a 768x768 leaf.  This rule is internal:
# no option or environment variable sets it.
TILE_IN_BYTES = 32 << 10
MIN_TILE = 1 << 10
WAVE_TILES = 32
BIG_WAVES = 8
VECTOR_TILES_PER_SM = {2: 24, 4: 0}


class Plan(NamedTuple):
    """How one launch splits its ``n`` elements, in order: ``tiles`` whole
    tiles of ``tile`` elements, ``vec_elems`` elements in 16-element
    groups, then ``tail`` elements one by one."""

    tiles: int
    tile: int
    vec_elems: int
    tail: int

    @property
    def path(self) -> str:
        return "bulk" if self.tiles else ("vector" if self.vec_elems else "element")


def _unplane_plan(n: int, itemsize: int, has_base: bool, aligned: bool, sms: int) -> Plan:
    """The split of a launch over ``n`` elements on a card of ``sms`` SMs;
    ``aligned``: every plane, the base and the output start on 16 bytes
    (bulk copies and 16-byte loads need it)."""
    if not aligned:
        return Plan(0, 0, 0, n)
    if n < max(MIN_TILE, VECTOR_TILES_PER_SM[itemsize] * sms * MIN_TILE):
        return Plan(0, 0, n - n % 16, n % 16)
    wave = WAVE_TILES * sms
    largest = TILE_IN_BYTES // (itemsize * (2 if has_base else 1)) // 16 * 16
    waves = max(1, -(-n // (largest * wave)))
    if waves > BIG_WAVES:
        tile, tiles = largest, n // largest
    else:
        tile = max(n // (waves * wave) // 16 * 16, MIN_TILE)
        tiles = min(n // tile, waves * wave)
    rest = n - tiles * tile
    return Plan(tiles, tile, rest - rest % 16, rest % 16)


def _check_args(planes, base, itemsize) -> int:
    if itemsize not in ELEM_DTYPES:
        raise ValueError(f"plane consumer: unsupported itemsize {itemsize}")
    if len(planes) != itemsize:
        raise ValueError(f"plane consumer: expected {itemsize} planes, got {len(planes)}")
    dev, n = planes[0].device, planes[0].numel()
    for p in planes:
        if p.dtype != torch.uint8 or p.dim() != 1 or not p.is_contiguous():
            raise ValueError("plane consumer: planes must be contiguous 1-d uint8")
        if p.device != dev or p.numel() != n:
            raise ValueError("plane consumer: planes differ in device or length")
    if base is not None:
        if (
            base.dtype != ELEM_DTYPES[itemsize] or base.dim() != 1
            or not base.is_contiguous() or base.device != dev or base.numel() != n
        ):
            raise ValueError(
                f"plane consumer: base must be a contiguous 1-d "
                f"{ELEM_DTYPES[itemsize]} tensor of {n} elements on {dev}"
            )
    return n


@functools.cache
def _launcher():
    fn = _build.load("unplane").unplane_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(itemsize: int, has_base: bool, tile: int) -> int:
    """The dynamic shared memory a block of a launch with tiles of ``tile``
    elements asks for (the kernel's stages), from the built library."""
    fn = _build.load("unplane").unplane_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(itemsize, int(has_base), tile))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plane_consumer(
    planes: Sequence[torch.Tensor],
    base: Optional[torch.Tensor] = None,
    *,
    itemsize: int,
) -> torch.Tensor:
    """Join ``planes`` (plane 0 most significant), rotate right by one bit,
    XOR ``base`` when given; returns int16/int32 element bits."""
    planes = list(planes)
    n = _check_args(planes, base, itemsize)
    if planes[0].device.type == "cpu":
        return plane_consumer_plain(planes, base, itemsize=itemsize)
    return launch(plane_consumer, planes, base, itemsize, n)


plane_consumer.launches = 0
plane_consumer.launches_by_path = dict.fromkeys(PATHS, 0)


def launch(fn, planes, base, itemsize, n) -> torch.Tensor:
    """Launch the kernel on ``n`` checked elements and count it, and its
    path, on ``fn``; K11 (``bytegroup.ungroup_*``) launches it without a
    base."""
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"{fn.__name__}: unsupported device {dev}")
    out = torch.empty(n, dtype=ELEM_DTYPES[itemsize], device=dev)
    if n == 0:
        return out
    ptrs = [p.data_ptr() for p in planes]
    if base is not None:
        ptrs.append(base.data_ptr())
    aligned = all(p % 16 == 0 for p in ptrs + [out.data_ptr()])
    plan = _unplane_plan(n, itemsize, base is not None, aligned, _sm_count(dev.index))
    rc = _launcher()(
        *ptrs[:itemsize], *([None] * (4 - itemsize)), None if base is None else ptrs[-1],
        out.data_ptr(), n, itemsize, plan.tiles, plan.tile,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("unplane", rc, f"{fn.__name__} launch")
    _build.count_launch(fn, plan.path)
    return out


def plane_consumer_plain(
    planes: Sequence[torch.Tensor],
    base: Optional[torch.Tensor] = None,
    *,
    itemsize: int,
) -> torch.Tensor:
    """Plain PyTorch K2 in int32 (2-byte) / int64 (4-byte) lanes with masks
    (CPU PyTorch has no shifts on unsigned 16/32-bit tensors)."""
    planes = list(planes)
    _check_args(planes, base, itemsize)
    if itemsize == 2:
        rot = (planes[0].to(torch.int32) << 8) | planes[1].to(torch.int32)
        x = ((rot >> 1) | ((rot & 1) << 15)) & 0xFFFF
        if base is not None:
            x = x ^ (base.to(torch.int32) & 0xFFFF)
        return x.to(torch.int16)       # narrowing keeps the low 16 bits
    rot = torch.zeros(planes[0].numel(), dtype=torch.int64, device=planes[0].device)
    for p in planes:
        rot = (rot << 8) | p.to(torch.int64)
    x = ((rot >> 1) | ((rot & 1) << 31)) & 0xFFFFFFFF
    if base is not None:
        x = x ^ (base.to(torch.int64) & 0xFFFFFFFF)
    return x.to(torch.int32)           # narrowing keeps the low 32 bits
