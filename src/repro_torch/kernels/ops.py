"""Public ops over the port's kernels K4–K6 and K8–K11: the counterpart of
the reference's ``repro.kernels.ops``, with its seven functions, names,
arguments and results, on tensors.

The tensor functions run on their inputs' device: a CUDA tensor goes
through the CUDA kernel, a CPU tensor through the kernel's plain PyTorch
version.  They take any length and any shape (flattened, as the
reference's 1-d arrays), with no padding to blocks.  Element bits are
int16/int32 tensors, the port's convention; ``torch.uint16`` /
``torch.uint32``, the reference's types, are taken too, by ``view``.

:func:`huffman_encode_chunks` takes numpy arrays or tensors.  Numpy inputs
go to ``device`` (default ``"cuda"``: without a card it raises unless the
caller asks for ``"cpu"``); a tensor of symbols stays on its device.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from .. import _util
from . import bitpack, bytegroup, histogram, xor_delta

__all__ = [
    "bytegroup_bf16",
    "ungroup_bf16",
    "bytegroup_fp32",
    "ungroup_fp32",
    "byte_histogram",
    "xor_delta_u32",
    "huffman_encode_chunks",
]

_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def _elems(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` flattened as contiguous ``dtype`` (int16/int32) element bits."""
    x = x.reshape(-1).contiguous()
    if _SIGNED.get(x.dtype) == dtype:
        x = x.view(dtype)
    if x.dtype != dtype:
        raise ValueError(f"expected {dtype} or its unsigned twin, got {x.dtype}")
    return x


def _bytes(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(-1).contiguous()
    if x.dtype != torch.uint8:
        raise ValueError(f"expected uint8, got {x.dtype}")
    return x


def bytegroup_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint16/int16[N] → (exponent uint8[N], frac|sign uint8[N])."""
    return bytegroup.bytegroup_bf16(_elems(x, torch.int16))


def ungroup_bf16(exp: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """(uint8[N], uint8[N]) → int16[N] element bits."""
    return bytegroup.ungroup_bf16(_bytes(exp), _bytes(frac))


def bytegroup_fp32(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """uint32/int32[N] → 4 × uint8[N] planes (plane 0 = exponent)."""
    return bytegroup.bytegroup_fp32(_elems(x, torch.int32))


def ungroup_fp32(*planes: torch.Tensor) -> torch.Tensor:
    """4 × uint8[N] → int32[N] element bits."""
    return bytegroup.ungroup_fp32(*(_bytes(p) for p in planes))


def byte_histogram(x: torch.Tensor) -> torch.Tensor:
    """uint8[N] → int32[256]."""
    return histogram.byte_histogram(_bytes(x))


def xor_delta_u32(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint32/int32[N],)² → (delta[N] in ``a``'s dtype, changed-byte count
    int32[])."""
    d, changed = xor_delta.xor_delta_u32(_elems(a, torch.int32), _elems(b, torch.int32))
    return d.view(a.dtype), changed


def _host_table(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return np.asarray(t).astype(np.int64)


def huffman_encode_chunks(
    syms: Any,
    lens: Any,
    codes: Any,
    chunk_syms: int = 1 << 13,
    *,
    device: Any = "cuda",
) -> List[bytes]:
    """The kernel counterpart of ``core.huffman.encode_chunks``, byte for
    byte the reference's ``ops.huffman_encode_chunks``.

    Splits ``syms`` into ``chunk_syms``-symbol chunks, the last padded with
    the symbol whose canonical code is all zero bits (its bits land after
    the true payload, so the last byte's slack stays zero), packs them with
    K8 under the one table, recomputes every chunk's true bits from the
    table and cuts each chunk's big-endian words to ``ceil(bits / 8)``
    bytes.  As in the reference, a chunk whose codes take more than its raw
    size comes back cut at ``chunk_syms`` bytes (its words hold no more):
    shorter than ``core.huffman.encode_chunks``' stream for it.
    """
    if isinstance(syms, torch.Tensor):
        dev = syms.device
        s = _bytes(syms)
    else:
        dev = _util.resolve_device(device)
        s = torch.from_numpy(np.ascontiguousarray(syms, dtype=np.uint8).reshape(-1)).to(dev)
    n = s.numel()
    if n == 0:
        return []
    lens_np, codes_np = _host_table(lens), _host_table(codes)
    if lens_np.size and not 0 <= lens_np.min() <= lens_np.max() <= bitpack.MAXL:
        # checked here, on the host copy: the kernel's own check reads nothing back
        raise ValueError(f"bitpack: code lengths must lie in 0..{bitpack.MAXL}")
    n_chunks = -(-n // chunk_syms)
    padded = s
    if n % chunk_syms or s.data_ptr() % 4:
        pad_sym = 0
        if n % chunk_syms:
            pad_sym = int(np.flatnonzero((lens_np > 0) & (codes_np == 0))[0])
        padded = torch.full((n_chunks * chunk_syms,), pad_sym, dtype=torch.uint8, device=dev)
        padded[:n] = s
    lens_t = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    codes_t = torch.from_numpy(codes_np.astype(np.int32)).to(dev)
    words, nbits = bitpack.bitpack_encode_chunks_single(
        padded, lens_t, codes_t, chunk_syms=chunk_syms
    )
    bits = torch.zeros(n_chunks * chunk_syms, dtype=torch.int64, device=dev)
    bits[:n] = lens_t.to(torch.int64)[s.to(torch.int64)]
    true_bits = bits.view(n_chunks, chunk_syms).sum(dim=1).cpu().tolist()
    if int(nbits.min()) < 0:                   # the table passed the check above
        raise RuntimeError("bitpack: K8 could not place a chunk's segments")
    raw = words.cpu().numpy().view(np.uint32).astype(">u4")
    return [raw[c].tobytes()[: -(-tb // 8)] for c, tb in enumerate(true_bits)]
