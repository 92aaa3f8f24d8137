"""Kernels K5 and K10: the XOR of two tensors' element bits, and the XOR
delta with its count of changed bytes.

:func:`xor_elems` (K5) and :func:`xor_delta_u32` (K10) launch the CUDA
kernel in ``csrc/xor_delta.cu`` on CUDA tensors and run
:func:`xor_elems_plain` / :func:`xor_delta_u32_plain`, their plain PyTorch
versions, on CPU tensors.  They raise on any other device; there is no
fallback from the kernel to the plain version.

Operands are contiguous 1-d tensors of one dtype and length: int16 or int32
element bits for K5 (the bits of uint16/uint32), int32 for K10.  Any ``n``
works, 0 included; there is no row-block padding.  :func:`xor_elems`
returns ``a ^ b`` in the operands' dtype, as the reference's
``xor_delta.xor_elems_2d`` does; :func:`xor_delta_u32` returns
``(a ^ b, changed)`` with ``changed`` the number of nonzero bytes of the
delta as a 0-d int32 tensor, the reference's ``xor_delta_2d`` count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["xor_elems", "xor_elems_plain", "xor_delta_u32", "xor_delta_u32_plain"]

_ELEM_DTYPES = (torch.int16, torch.int32)


def _check_args(a, b, dtypes) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in dtypes or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"xor: {name} must be a contiguous 1-d tensor of {dtypes}, "
                f"got {t.dtype} of shape {tuple(t.shape)}"
            )
    if a.dtype != b.dtype or a.device != b.device or a.numel() != b.numel():
        raise ValueError("xor: a and b differ in dtype, device or length")


@functools.cache
def _launcher():
    fn = _build.load("xor_delta").xor_delta_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(a, b, count: Optional[torch.Tensor], what: str) -> torch.Tensor:
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    d = torch.empty_like(a)
    ptrs = (a.data_ptr(), b.data_ptr(), d.data_ptr())
    rc = _launcher()(
        *ptrs, None if count is None else count.data_ptr(),
        a.numel() * a.element_size(), int(all(p % 16 == 0 for p in ptrs)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("xor_delta", rc, f"{what} launch")
    return d


def xor_elems(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a ^ b`` at the operands' width (int16 or int32 element bits)."""
    _check_args(a, b, _ELEM_DTYPES)
    if a.device.type == "cpu":
        return xor_elems_plain(a, b)
    if a.numel() == 0:
        return torch.empty_like(a)
    d = _launch(a, b, None, "xor_elems")
    _build.count_launch(xor_elems)
    return d


xor_elems.launches = 0


def xor_elems_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K5: XOR needs no shifts, so it runs on the signed
    element bits as they are."""
    _check_args(a, b, _ELEM_DTYPES)
    return a ^ b


def xor_delta_u32(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``a ^ b``, nonzero bytes of it as a 0-d int32) for int32 element bits."""
    _check_args(a, b, (torch.int32,))
    dev = a.device
    if dev.type == "cpu":
        return xor_delta_u32_plain(a, b)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if a.numel() == 0:
        return torch.empty_like(a), count
    d = _launch(a, b, count, "xor_delta_u32")
    _build.count_launch(xor_delta_u32)
    return d, count


xor_delta_u32.launches = 0


def xor_delta_u32_plain(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K10: the XOR, then each of the four bytes of every
    word tested for zero in int64 lanes with masks."""
    _check_args(a, b, (torch.int32,))
    d = a ^ b
    w = d.to(torch.int64) & 0xFFFFFFFF
    changed = torch.zeros((), dtype=torch.int64, device=a.device)
    for s in (0, 8, 16, 24):
        changed += (((w >> s) & 0xFF) != 0).sum()
    return d, changed.to(torch.int32)
