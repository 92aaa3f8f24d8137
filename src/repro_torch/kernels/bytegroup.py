"""Kernels K4 and K11: byte grouping and its inverse, for bf16 and fp32.

:func:`bytegroup_bf16` / :func:`bytegroup_fp32` (K4) launch the CUDA
kernel in ``csrc/bytegroup.cu`` on CUDA tensors; :func:`ungroup_bf16` /
:func:`ungroup_fp32` (K11) launch K2's kernel (``csrc/unplane.cu``)
without a base, each counting its own launches.  All run their ``_plain``
versions on CPU tensors and raise on any other device; there is no
fallback from the kernel to the plain version.

K4 takes ``n`` elements of element bits, a contiguous 1-d int16 tensor
(bf16) or int32 tensor (fp32), rotates each left by one bit and returns
its bytes as 2 or 4 uint8 planes of ``n`` bytes, plane 0 the most
significant (the exponent).  K11 takes the planes back and returns the
element bits.  Any ``n`` works, 0 included; there is no row-block padding.
Both equal, bit for bit, the reference's ``bytegroup.bytegroup_*_2d`` and
``ungroup_*_2d``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import _build, fused_unplane

__all__ = [
    "bytegroup_bf16",
    "bytegroup_bf16_plain",
    "bytegroup_fp32",
    "bytegroup_fp32_plain",
    "ungroup_bf16",
    "ungroup_bf16_plain",
    "ungroup_fp32",
    "ungroup_fp32_plain",
]

_ELEM_DTYPES = {2: torch.int16, 4: torch.int32}
_SHIFTS = {2: (8, 0), 4: (24, 16, 8, 0)}          # plane k's byte of the rotated word


def _check_elems(x, itemsize) -> int:
    if x.dtype != _ELEM_DTYPES[itemsize] or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(
            f"bytegroup: x must be a contiguous 1-d {_ELEM_DTYPES[itemsize]} tensor, "
            f"got {x.dtype} of shape {tuple(x.shape)}"
        )
    return x.numel()


@functools.cache
def _launcher():
    fn = _build.load("bytegroup").bytegroup_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(ptrs) -> int:
    return int(all(p % 16 == 0 for p in ptrs))


def _group(x: torch.Tensor, itemsize: int, fn) -> Tuple[torch.Tensor, ...]:
    n = _check_elems(x, itemsize)
    dev = x.device
    if dev.type == "cpu":
        return group_plain(x, itemsize)
    if dev.type != "cuda":
        raise ValueError(f"bytegroup: unsupported device {dev}")
    planes = tuple(torch.empty(n, dtype=torch.uint8, device=dev) for _ in range(itemsize))
    if n == 0:
        return planes
    ptrs = [p.data_ptr() for p in planes]
    rc = _launcher()(
        x.data_ptr(), *ptrs, *([None] * (4 - itemsize)), n, itemsize,
        _aligned([x.data_ptr(), *ptrs]), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("bytegroup", rc, f"{fn.__name__} launch")
    _build.count_launch(fn)
    return planes


def _ungroup(planes: Sequence[torch.Tensor], itemsize: int, fn) -> torch.Tensor:
    planes = list(planes)
    n = fused_unplane._check_args(planes, None, itemsize)
    if planes[0].device.type == "cpu":
        return fused_unplane.plane_consumer_plain(planes, itemsize=itemsize)
    return fused_unplane.launch(fn, planes, None, itemsize, n)      # K11 is K2 without a base


def group_plain(x: torch.Tensor, itemsize: int) -> Tuple[torch.Tensor, ...]:
    """Plain K4 of checked element bits: rotate left by one in int64 lanes
    with masks (CPU PyTorch has no shifts on unsigned 16/32-bit tensors)
    and split, plane 0 the most significant byte.  K3's plain version
    runs it after its XOR."""
    bits = 8 * itemsize
    mask = (1 << bits) - 1
    v = x.to(torch.int64) & mask
    rot = ((v << 1) | (v >> (bits - 1))) & mask
    return tuple(((rot >> s) & 0xFF).to(torch.uint8) for s in _SHIFTS[itemsize])


def bytegroup_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int16 element bits → (exponent plane, low plane), uint8 each."""
    return _group(x, 2, bytegroup_bf16)


def bytegroup_fp32(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """int32 element bits → 4 uint8 planes, plane 0 the exponent."""
    return _group(x, 4, bytegroup_fp32)


def ungroup_bf16(exp: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """(exponent plane, low plane) → int16 element bits."""
    return _ungroup((exp, frac), 2, ungroup_bf16)


def ungroup_fp32(*planes: torch.Tensor) -> torch.Tensor:
    """4 uint8 planes, plane 0 most significant → int32 element bits."""
    return _ungroup(planes, 4, ungroup_fp32)


for _fn in (bytegroup_bf16, bytegroup_fp32, ungroup_bf16, ungroup_fp32):
    _fn.launches = 0
for _fn in (ungroup_bf16, ungroup_fp32):                  # K2's kernel: counted by path
    _fn.launches_by_path = dict.fromkeys(fused_unplane.PATHS, 0)


def bytegroup_bf16_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4, bf16."""
    _check_elems(x, 2)
    return group_plain(x, 2)


def bytegroup_fp32_plain(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch K4, fp32."""
    _check_elems(x, 4)
    return group_plain(x, 4)


def ungroup_bf16_plain(exp: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K11, bf16: K2's plain version without a base."""
    return fused_unplane.plane_consumer_plain([exp, frac], itemsize=2)


def ungroup_fp32_plain(*planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K11, fp32: K2's plain version without a base."""
    return fused_unplane.plane_consumer_plain(list(planes), itemsize=4)
