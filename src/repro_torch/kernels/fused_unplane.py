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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from . import _build

__all__ = ["ELEM_DTYPES", "plane_consumer", "plane_consumer_plain"]

ELEM_DTYPES = {2: torch.int16, 4: torch.int32}


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
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


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


def launch(fn, planes, base, itemsize, n) -> torch.Tensor:
    """Launch the kernel on ``n`` checked elements and count it on ``fn``;
    K11 (``bytegroup.ungroup_*``) launches it without a base."""
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"{fn.__name__}: unsupported device {dev}")
    out = torch.empty(n, dtype=ELEM_DTYPES[itemsize], device=dev)
    if n == 0:
        return out
    ptrs = [p.data_ptr() for p in planes] + [None] * (4 - itemsize)
    rc = _launcher()(
        *ptrs, None if base is None else base.data_ptr(), out.data_ptr(),
        n, itemsize, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("unplane", rc, f"{fn.__name__} launch")
    _build.count_launch(fn)
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
