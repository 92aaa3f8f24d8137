"""Compressibility statistics: exponent histograms, entropy, categories.
A port of ``repro.core.stats``.

Backs the paper's analysis figures (Fig. 2 exponent skew, Fig. 6 per-group
breakdown) and the model-category classifier ("regular" vs "clean", §3).

Inputs are tensors, or numpy arrays (bf16 ones by their dtype name), which
go to ``device`` (default ``"cuda"``: without a card it raises unless the
caller asks for ``"cpu"``); a tensor stays on its own device.  The counts
come from the port's kernels there: byte planes from K4
(``kernels.ops.bytegroup_bf16`` / ``bytegroup_fp32``, whose plane 0 is the
exponent of bf16 and fp32), an fp16 or fp8 exponent by a shift and mask,
and every 256-bin count from K9 (``kernels.ops.byte_histogram``); on a CPU
tensor the kernels' plain versions run.  Only the 256 counts go to the
host.  Everything after them is the reference's float64 numpy arithmetic,
so entropies, masses and ratios are the reference's bit for bit (a torch
reduction would sum in another order, and another sort would order ties
otherwise than ``np.argsort``).  Layouts no kernel covers (fp64, integers,
fp8 planes) are split on the host by the port's ``bitlayout``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _util
from ..convert import tensor_from_numpy
from ..kernels import ops
from . import bitlayout

__all__ = [
    "byte_entropy",
    "exponent_histogram",
    "plane_report",
    "classify_model",
    "theoretical_ratio",
    "gib",
    "human_gbps",
]

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
# K9 counts in int32: a tensor is counted in pieces under 2^31 bytes
_COUNT_PIECE = 1 << 30


def as_tensor(x: Any, device: Any = "cuda") -> torch.Tensor:
    """``x`` itself if it is a tensor, else the numpy array (or the bytes)
    on ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (bytes, bytearray, memoryview)):
        x = np.frombuffer(x, dtype=np.uint8)
    return tensor_from_numpy(np.asarray(x), _util.resolve_device(device))


def _layout(x: torch.Tensor) -> bitlayout.BitLayout:
    return bitlayout.layout_for(_util.dtype_name(x.dtype))


def _bits(x: torch.Tensor, layout: bitlayout.BitLayout) -> torch.Tensor:
    """``x``'s elements as flat integer bits of the layout's width."""
    return x.reshape(-1).contiguous().view(_BITS[layout.itemsize])


def kernel_planes(x: torch.Tensor,
                  layout: bitlayout.BitLayout) -> Optional[Tuple[torch.Tensor, ...]]:
    """K4's byte planes of ``x`` (flat element bits or bytes), on its
    device, where K4 covers the layout (2- and 4-byte rotated floats:
    bf16, fp16, fp32); else None.  ``bitlayout.to_planes`` of the same
    bytes, bit for bit."""
    if not layout.rotate or layout.sub_byte or layout.itemsize not in (2, 4):
        return None
    bits = x.reshape(-1).view(_BITS[layout.itemsize])
    if layout.itemsize == 2:
        return ops.bytegroup_bf16(bits)
    return ops.bytegroup_fp32(bits)


def _planes(x: torch.Tensor, layout: bitlayout.BitLayout):
    planes = kernel_planes(_bits(x, layout), layout)
    if planes is not None:
        return planes
    if layout.itemsize == 1 and not layout.sub_byte:
        return (_bits(x, layout),)
    return bitlayout.to_planes(_bits(x, layout).cpu().numpy().view(np.uint8), layout)


def _counts(p) -> np.ndarray:
    """The 256 byte counts of a uint8 plane as int64: K9 (or its plain
    version) on a tensor, ``np.bincount`` on a host plane."""
    if isinstance(p, np.ndarray):
        return np.bincount(p, minlength=256)
    p = p.reshape(-1)
    total = np.zeros(256, dtype=np.int64)
    for i in range(0, p.numel(), _COUNT_PIECE):
        total += ops.byte_histogram(p[i:i + _COUNT_PIECE]).cpu().numpy()
    return total


def _size(p) -> int:
    return p.size if isinstance(p, np.ndarray) else p.numel()


def _entropy(counts: np.ndarray, n: int) -> float:
    """The reference's ``byte_entropy`` after its ``bincount``."""
    if n == 0:
        return 0.0
    hist = counts.astype(np.float64)
    p = hist[hist > 0] / n
    return float(-(p * np.log2(p)).sum())


def byte_entropy(data: Any, *, device: Any = "cuda") -> float:
    """Shannon entropy (bits/byte) of a uint8 stream."""
    x = as_tensor(data, device).reshape(-1)
    return _entropy(_counts(x), x.numel())


def exponent_histogram(arr: Any, *, device: Any = "cuda") -> Dict[str, Any]:
    """Fig. 2: distribution of biased exponent values."""
    x = as_tensor(arr, device)
    layout = _layout(x)
    if layout.exp_bits == 0:
        raise ValueError(f"dtype {_util.dtype_name(x.dtype)} has no exponent")
    if layout.exp_bits > 8:                  # fp64: 11 bits, counted on the host
        hist = np.bincount(bitlayout.exponent_view(
            _bits(x, layout).cpu().numpy().view(np.float64)).ravel(), minlength=256)
    else:
        planes = kernel_planes(_bits(x, layout), layout) if layout.exp_bits == 8 else None
        if planes is not None:
            exps = planes[0]                 # bf16, fp32: plane 0 is the exponent
        else:                                # fp16, fp8: shift and mask
            v = _bits(x, layout).to(torch.int32) & ((1 << layout.total_bits) - 1)
            exps = ((v >> layout.frac_bits) & ((1 << layout.exp_bits) - 1)).to(torch.uint8)
        hist = _counts(exps)
    nz = np.nonzero(hist)[0]
    top = np.argsort(hist)[::-1]
    total = hist.sum()
    top12 = float(hist[top[:12]].sum() / max(total, 1))
    return {
        "hist": hist,
        "distinct_values": int(nz.size),
        "top12_mass": top12,
        "min_exp": int(nz.min()) if nz.size else 0,
        "max_exp": int(nz.max()) if nz.size else 0,
    }


def plane_report(arr: Any, *, device: Any = "cuda") -> List[Dict[str, float]]:
    """Per-byte-group entropy + implied Huffman ratio (Fig. 6 style)."""
    x = as_tensor(arr, device)
    out = []
    for i, p in enumerate(_planes(x, _layout(x))):
        counts, n = _counts(p), _size(p)
        h = _entropy(counts, n)
        out.append(
            {
                "plane": i,
                "entropy_bits": h,
                "est_ratio_pct": 100.0 * h / 8.0,
                "zero_frac": float(counts[0] / n) if n else 0.0,
            }
        )
    return out


def classify_model(tree_leaves: List[Any], *, device: Any = "cuda") -> str:
    """'clean' if fraction planes show real compressibility, else 'regular'.

    Paper §3: clean models (rounded / type-converted post-training) compress
    in the fraction too; regular models only in the exponent.  We sample the
    fraction planes (their first 2^20 bytes) of the 8 largest leaves of at
    least 1024 elements and look at byte entropy.
    """
    frac_entropy = []
    leaves = sorted(tree_leaves, key=lambda a: -_size(a))[:8]
    for a in leaves:
        try:
            layout = bitlayout.layout_for(
                _util.dtype_name(a.dtype) if isinstance(a, torch.Tensor) else a.dtype.name)
        except ValueError:
            continue
        if layout.exp_bits == 0 or _size(a) < 1024:
            continue
        for p in _planes(as_tensor(a, device), layout)[1:]:
            sample = p[: 1 << 20]
            frac_entropy.append(_entropy(_counts(sample), _size(sample)))
    if not frac_entropy:
        return "regular"
    # any fraction plane with < 7.2 bits/byte of entropy ⇒ compressible ⇒ clean
    return "clean" if min(frac_entropy) < 7.2 else "regular"


def theoretical_ratio(arr: Any, *, device: Any = "cuda") -> float:
    """Entropy-bound compressed size (%) with byte grouping — sanity bound."""
    rep = plane_report(arr, device=device)
    return sum(r["est_ratio_pct"] for r in rep) / max(len(rep), 1)


def gib(n_bytes: int) -> float:
    return n_bytes / float(1 << 30)


def human_gbps(n_bytes: int, seconds: float) -> float:
    if seconds <= 0:
        return math.inf
    return n_bytes / seconds / 1e9
