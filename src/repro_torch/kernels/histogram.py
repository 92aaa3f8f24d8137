"""Kernels K9 and K6: 256-bin byte histograms, of a whole array and of
every chunk of it.

:func:`byte_histogram` (K9) and :func:`chunk_histogram` (K6) launch the
CUDA kernel in ``csrc/histogram.cu`` on CUDA tensors (K9 as one chunk of
all ``n`` bytes) and run :func:`byte_histogram_plain` /
:func:`chunk_histogram_plain`, their plain PyTorch versions, on CPU
tensors.  They raise on any other device; there is no fallback from the
kernel to the plain version.

``x`` is a contiguous 1-d uint8 tensor of any length, 0 included.
:func:`byte_histogram` returns int32[256], the reference's
``ops.byte_histogram`` (which pads to whole blocks and takes the padding
back out of bin 0; here nothing is padded).  :func:`chunk_histogram`
returns int32[ceil(n / chunk_elems), 256], the counts of every chunk of
``chunk_elems`` bytes: where ``chunk_elems`` divides ``n`` that is the
reference's ``histogram.chunk_histogram_2d``; otherwise the last row counts
the shorter last chunk.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = [
    "byte_histogram",
    "byte_histogram_plain",
    "chunk_histogram",
    "chunk_histogram_plain",
]


def _check_args(x, chunk_elems) -> int:
    if x.dtype != torch.uint8 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(
            f"histogram: x must be a contiguous 1-d uint8 tensor, "
            f"got {x.dtype} of shape {tuple(x.shape)}"
        )
    if chunk_elems <= 0:
        raise ValueError(f"histogram: chunk_elems must be positive, got {chunk_elems}")
    return -(-x.numel() // chunk_elems)


@functools.cache
def _launcher():
    fn = _build.load("histogram").histogram_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, chunk_elems, n_chunks, what) -> torch.Tensor:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    hist = torch.zeros((n_chunks, 256), dtype=torch.int32, device=dev)
    rc = _launcher()(
        x.data_ptr(), hist.data_ptr(), x.numel(), chunk_elems,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("histogram", rc, f"{what} launch")
    return hist


def chunk_histogram(x: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Byte counts of every ``chunk_elems``-byte chunk of ``x``:
    int32[ceil(n / chunk_elems), 256]."""
    n_chunks = _check_args(x, chunk_elems)
    if x.device.type == "cpu":
        return chunk_histogram_plain(x, chunk_elems)
    if n_chunks == 0:
        return torch.zeros((0, 256), dtype=torch.int32, device=x.device)
    hist = _launch(x, chunk_elems, n_chunks, "chunk_histogram")
    _build.count_launch(chunk_histogram)
    return hist


chunk_histogram.launches = 0


def chunk_histogram_plain(x: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Plain PyTorch K6: one ``bincount`` over (chunk, byte) keys."""
    n_chunks = _check_args(x, chunk_elems)
    chunk = torch.arange(x.numel(), device=x.device) // chunk_elems
    keys = chunk * 256 + x.to(torch.int64)
    return torch.bincount(keys, minlength=n_chunks * 256).to(torch.int32).view(n_chunks, 256)


def byte_histogram(x: torch.Tensor) -> torch.Tensor:
    """Byte counts of all of ``x``: int32[256]."""
    _check_args(x, 1)
    if x.device.type == "cpu":
        return byte_histogram_plain(x)
    if x.numel() == 0:
        return torch.zeros(256, dtype=torch.int32, device=x.device)
    hist = _launch(x, x.numel(), 1, "byte_histogram")
    _build.count_launch(byte_histogram)
    return hist.view(256)


byte_histogram.launches = 0


def byte_histogram_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K9: one ``bincount`` of the bytes."""
    _check_args(x, 1)
    return torch.bincount(x.to(torch.int64), minlength=256).to(torch.int32)
