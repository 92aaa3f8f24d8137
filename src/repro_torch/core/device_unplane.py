"""Device plane consumer: decoded byte-group planes → tensor elements (K2).

After the entropy stage rebuilds a tensor's uint8 planes on the device,
:func:`consume_planes` runs un-byte-group, inverse rotate-left-1 and the
optional inverse XOR-delta as one launch of
:func:`repro_torch.kernels.plane_consumer` and returns the element bits
(int16 for 2-byte layouts, int32 for 4-byte ones) on the planes' device —
no host bounce.  :func:`consume_planes_batched` packs many same-layout
tensors into one launch; :func:`consume_payloads` chains the Huffman
decode (:func:`.device_entropy.decode_planes`) and the consumer, so the
compressed payload is the only data-sized host→device transfer.

Support envelope: rotated 2- and 4-byte layouts (bf16 / fp16 / fp32).
Decoded bits equal :func:`.bitlayout.from_planes` exactly.

``device_resident`` (default False, as in the reference) says where the
result goes: True keeps it on the planes' device, False copies it to a
CPU tensor.  The codec's own calls pass True.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from ..kernels import plane_consumer
from . import bitlayout, device_entropy

__all__ = ["supports", "consume_planes", "consume_planes_batched", "consume_payloads"]


def supports(layout: bitlayout.BitLayout) -> bool:
    """Can the device consumer rebuild this layout's elements?"""
    return layout.rotate and layout.itemsize in (2, 4) and not layout.sub_byte


def _placed(elems: torch.Tensor, device_resident: bool) -> torch.Tensor:
    return elems if device_resident else elems.cpu()


def consume_planes(
    planes: Sequence[torch.Tensor],
    layout: bitlayout.BitLayout,
    base: Optional[torch.Tensor] = None,
    device_resident: bool = False,
) -> torch.Tensor:
    """One tensor's planes → flat element bits (``base`` XORed in when
    given, as element bits of the same dtype), on the planes' device with
    ``device_resident``, else on the CPU."""
    if not supports(layout):
        raise ValueError(
            f"device plane consumer does not support layout {layout.name!r}"
        )
    if len(planes) != layout.n_planes:
        raise ValueError(f"expected {layout.n_planes} planes, got {len(planes)}")
    elems = plane_consumer(list(planes), base, itemsize=layout.itemsize)
    return _placed(elems, device_resident)


def consume_planes_batched(
    planes_list: Sequence[Sequence[torch.Tensor]],
    layout: bitlayout.BitLayout,
    bases: Optional[Sequence[Optional[torch.Tensor]]] = None,
    device_resident: bool = False,
) -> List[torch.Tensor]:
    """Many same-layout tensors' planes → per-tensor flat element bits.

    Each plane index is concatenated across tensors and one launch
    rebuilds them all; the results are views into one element buffer (on
    the planes' device with ``device_resident``, else on the CPU).
    ``bases[i]`` None means no delta for tensor ``i`` (XOR identity).
    """
    if bases is not None and len(bases) != len(planes_list):
        raise ValueError("bases must pair 1:1 with planes_list")
    if not planes_list:
        return []
    sizes = [int(planes[0].numel()) for planes in planes_list]
    cat = [
        torch.cat([planes[p] for planes in planes_list])
        for p in range(layout.n_planes)
    ]
    base = None
    if bases is not None and any(b is not None for b in bases):
        dt = torch.int16 if layout.itemsize == 2 else torch.int32
        base = torch.cat([
            b if b is not None else torch.zeros(s, dtype=dt, device=cat[0].device)
            for b, s in zip(bases, sizes)
        ])
    elems = consume_planes(cat, layout, base, device_resident=device_resident)
    return list(torch.split(elems, sizes))


def consume_payloads(
    entries_all: Sequence[Sequence[Any]],
    payloads_all: Sequence[Sequence[bytes]],
    tables_all: Sequence[Optional[bytes]],
    params: Any,
    layout: bitlayout.BitLayout,
    base: Optional[torch.Tensor] = None,
    pool=None,
    device: Any = "cuda",
    device_resident: bool = False,
) -> torch.Tensor:
    """Compressed payloads → flat element bits: K1 decodes the HUFF chunks
    on ``device``, K2 consumes the planes in place; the elements stay on
    ``device`` with ``device_resident``, else come back as a CPU tensor."""
    planes = device_entropy.decode_planes(
        entries_all, payloads_all, tables_all, params, pool=pool, device=device,
        device_resident=True,
    )
    return consume_planes(planes, layout, base, device_resident=device_resident)
