"""Kernel K3: the plane producer — XOR base, rotate, byte-group, histograms.

:func:`plane_producer` launches the CUDA kernel in ``csrc/plane.cu`` on
CUDA tensors and runs :func:`plane_producer_plain`, its plain PyTorch
version, on CPU tensors.  It raises on any other device; there is no
fallback from the kernel to the plain version.

``x`` is ``n`` elements of element bits, int16 for ``itemsize`` 2 and
int32 for 4 (the bits of uint16/uint32: bf16/fp16/fp32 viewed as
integers); ``base``, when given, is ``n`` elements of the same dtype,
XORed in first (the delta path).  ``chunk_elems`` must divide ``n``: the
caller pads every tensor to whole codec chunks with zeros, which rotate
and XOR leave zero, so padding only adds to bin 0 of a chunk's
histograms.

Returns ``(planes, hists)``: ``planes`` uint8 ``(itemsize, n)``, row 0
the most significant byte after the rotate-left-1 (the exponent), and
``hists`` int32 ``(n // chunk_elems, itemsize, 256)``, the byte counts of
every plane in every chunk.  Both equal, bit for bit, what the reference's
``fused_plane.plane_producer`` returns for the same zero-padded input.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .bytegroup import group_plain

__all__ = ["ELEM_DTYPES", "CHUNK_ALIGN_BYTES", "plane_producer", "plane_producer_plain"]

ELEM_DTYPES = {2: torch.int16, 4: torch.int32}
# Per-plane chunk sizes the device plane path takes (bytes = elements):
# the reference's histogram block, HIST_ROWS * 128 in
# src/repro/kernels/histogram.py.  The kernel itself takes any chunk size.
CHUNK_ALIGN_BYTES = 128 * 128


def _check_args(x, base, itemsize, chunk_elems) -> int:
    if itemsize not in ELEM_DTYPES:
        raise ValueError(f"plane producer: unsupported itemsize {itemsize}")
    if x.dtype != ELEM_DTYPES[itemsize] or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(
            f"plane producer: x must be a contiguous 1-d {ELEM_DTYPES[itemsize]} tensor"
        )
    n = x.numel()
    if base is not None and (
        base.dtype != x.dtype or base.dim() != 1 or not base.is_contiguous()
        or base.device != x.device or base.numel() != n
    ):
        raise ValueError(
            f"plane producer: base must be a contiguous 1-d {x.dtype} tensor "
            f"of {n} elements on {x.device}"
        )
    if chunk_elems <= 0 or n % chunk_elems:
        raise ValueError(
            f"plane producer: chunk_elems {chunk_elems} does not divide n = {n}"
        )
    return n


@functools.cache
def _launcher():
    fn = _build.load("plane").plane_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def plane_producer(
    x: torch.Tensor,
    base: Optional[torch.Tensor] = None,
    *,
    itemsize: int,
    chunk_elems: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """XOR ``base`` when given, rotate left by one bit, split into
    ``itemsize`` byte planes and count every plane's bytes per chunk."""
    n = _check_args(x, base, itemsize, chunk_elems)
    dev = x.device
    if dev.type == "cpu":
        return plane_producer_plain(x, base, itemsize=itemsize, chunk_elems=chunk_elems)
    if dev.type != "cuda":
        raise ValueError(f"plane producer: unsupported device {dev}")
    planes = torch.empty((itemsize, n), dtype=torch.uint8, device=dev)
    hists = torch.zeros((n // chunk_elems, itemsize, 256), dtype=torch.int32, device=dev)
    if n == 0:
        return planes, hists
    rc = _launcher()(
        x.data_ptr(), None if base is None else base.data_ptr(),
        planes.data_ptr(), hists.data_ptr(), n, chunk_elems, 0, itemsize,   # 0: tiles fill a wave
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("plane", rc, "plane_producer launch")
    _build.count_launch(plane_producer)
    return planes, hists


plane_producer.launches = 0


def plane_producer_plain(
    x: torch.Tensor,
    base: Optional[torch.Tensor] = None,
    *,
    itemsize: int,
    chunk_elems: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3: the XOR on the element bits, K4's plain rotate and
    split, and the histograms as one ``bincount`` over (chunk, plane,
    byte) keys."""
    n = _check_args(x, base, itemsize, chunk_elems)
    dev = x.device
    planes = torch.stack(group_plain(x if base is None else x ^ base, itemsize))
    n_chunks = n // chunk_elems
    chunk = torch.arange(n, device=dev) // chunk_elems
    row = chunk.view(1, n) * itemsize + torch.arange(itemsize, device=dev).view(itemsize, 1)
    keys = (row * 256 + planes.to(torch.int64)).reshape(-1)
    hists = torch.bincount(keys, minlength=n_chunks * itemsize * 256)
    return planes, hists.to(torch.int32).view(n_chunks, itemsize, 256)
