"""Codec options: one frozen bag for the knobs every entry point takes.

:class:`CodecOptions` rides an ``options=`` keyword on every codec entry
point of :mod:`.zipnn` and on the serving store:

    opts = CodecOptions(threads=-1, backend="device")
    blob = zipnn.compress_bytes(raw, "bfloat16", options=opts)

``None`` fields mean "defer to the ``ZipNNConfig``", so the precedence is
the reference's: options field > config field, and an unset
``entropy_backend`` (in both) follows the plane ``backend``.
``threads``, ``backend`` and ``entropy_backend`` never change bytes: they
choose where the work runs — host pool, or the card's encode kernels (K3
plane producer, K7 bit-pack) on the entry point's ``device``.
``device_resident`` is a semantic flag: it changes what a decode entry
point returns (a tensor on the entry point's ``device`` instead of a CPU
tensor).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["BACKENDS", "CodecOptions", "DEFAULT_OPTIONS", "resolve_backend", "resolve_options"]

BACKENDS = ("host", "device", "auto")


@dataclasses.dataclass(frozen=True)
class CodecOptions:
    """Per-call codec knobs.

    threads:          0/1 serial, N>1 pool workers, -1 all cores.
    backend:          plane stage — 'host' | 'device' | 'auto' (device only
                      for leaves on a CUDA device); the decode of a delta
                      stream follows it too.
    entropy_backend:  Huffman bit-pack stage — same values; None follows
                      ``backend``.
    device_resident:  decode paths only — return restored leaves on the
                      entry point's ``device``.
    """

    threads: Optional[int] = None
    backend: Optional[str] = None
    entropy_backend: Optional[str] = None
    device_resident: bool = False

    def replace(self, **changes) -> "CodecOptions":
        return dataclasses.replace(self, **changes)


DEFAULT_OPTIONS = CodecOptions()


def resolve_options(
    options: Optional[CodecOptions] = None,
    *,
    device_resident: Optional[bool] = None,
) -> CodecOptions:
    """The options bag for one call: ``options`` (default bag when None)
    with an explicit ``device_resident`` kwarg applied over its field."""
    if options is None:
        options = DEFAULT_OPTIONS
    if device_resident is not None:
        return options.replace(device_resident=device_resident)
    return options


def resolve_backend(
    requested: Optional[str], supported: bool, leaf: Any = None, stage: str = "plane"
) -> str:
    """Collapse one stage's backend request to 'host' or 'device'.

    ``supported`` is the stage's envelope check for the leaf (its
    ``supports(layout, params)``): outside it every request routes to the
    host, as the reference routes it, so bytes never change.  ``"auto"``
    takes the device only for a leaf already on a CUDA device.
    """
    if requested is None or requested == "host":
        return "host"
    if requested == "device":
        return "device" if supported else "host"
    if requested == "auto":
        on_card = isinstance(leaf, torch.Tensor) and leaf.is_cuda
        return "device" if supported and on_card else "host"
    raise ValueError(
        f"unknown {stage} backend {requested!r}; expected one of {BACKENDS}"
    )
