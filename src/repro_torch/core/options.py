"""Codec options: one frozen bag for the knobs every entry point takes,
and :class:`ZipNNSession`, which binds a config and a bag once.

:class:`CodecOptions` rides an ``options=`` keyword on every codec entry
point of :mod:`.zipnn` and :mod:`.engine`, on the serving store and on the
checkpoint manager:

    opts = CodecOptions(threads=-1, backend="device")
    blob = zipnn.compress_bytes(raw, "bfloat16", options=opts)

``None`` fields mean "defer to the ``ZipNNConfig``", so the precedence is
the reference's: options field > config field, and an unset
``entropy_backend`` (in both) follows the plane ``backend``.  The config's
``plane_backend`` defaults to ``"auto"`` (:func:`resolve_backend`): the
card's kernels encode tensors that lie on a CUDA device, and encode host
bytes (byte streams, file frames) and decode whenever the entry point's
``device`` is a card that is present; CPU tensors, and everything on a
machine without a card, take the host path.  ``threads``, ``backend`` and
``entropy_backend`` never change bytes: they choose where the work runs —
host pool, or the card's kernels (K3 plane producer and K7 bit-pack on encode, K1 Huffman decode
and K2 plane consumer on decode) on the entry point's ``device``.
``device_resident`` is a semantic flag: it changes what a decode entry
point returns (a tensor on the entry point's ``device`` instead of a CPU
tensor).

The legacy per-call kwargs ``threads=``, ``backend=``, ``entropy_backend=``
and ``device_resident=`` keep working on every entry point that takes
``options=``, as in the reference: :func:`resolve_options` merges them
with the precedence

    explicit legacy kwarg  >  options field  >  ZipNNConfig field

and one :class:`DeprecationWarning` for the three codec knobs
(``device_resident`` is a flag, not a knob, and does not warn).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional

import torch

__all__ = [
    "BACKENDS", "CodecOptions", "DEFAULT_OPTIONS", "ZipNNSession", "resolve_backend",
    "resolve_options",
]

BACKENDS = ("host", "device", "auto")


@dataclasses.dataclass(frozen=True)
class CodecOptions:
    """Per-call codec knobs.

    threads:          0/1 serial, N>1 pool workers, -1 all cores.
    backend:          plane stage — 'host' | 'device' | 'auto' (device for
                      tensors on a CUDA device, and for host bytes when
                      ``device`` is a card that is present); on decode the
                      back half (K2).
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


_LEGACY_MSG = (
    "passing threads=/backend=/entropy_backend= per call is deprecated; "
    "pass options=CodecOptions(...) instead (explicit legacy kwargs still "
    "override the options fields)"
)


def resolve_options(
    options: Optional[CodecOptions] = None,
    *,
    threads: Optional[int] = None,
    backend: Optional[str] = None,
    entropy_backend: Optional[str] = None,
    device_resident: Optional[bool] = None,
    _stacklevel: int = 3,
) -> CodecOptions:
    """The options bag for one call: ``options`` (the default bag when
    None) with every explicit legacy kwarg applied over its field.

    The three codec knobs emit one :class:`DeprecationWarning`, attributed
    ``_stacklevel`` frames up (the entry point's caller by default);
    ``device_resident`` does not warn.  ``None`` fields still mean "defer
    to the ``ZipNNConfig``" downstream."""
    if options is None:
        options = DEFAULT_OPTIONS
    legacy: Dict[str, Any] = {}
    if threads is not None:
        legacy["threads"] = threads
    if backend is not None:
        legacy["backend"] = backend
    if entropy_backend is not None:
        legacy["entropy_backend"] = entropy_backend
    if legacy:
        warnings.warn(_LEGACY_MSG, DeprecationWarning, stacklevel=_stacklevel)
    if device_resident is not None:
        legacy["device_resident"] = device_resident
    return dataclasses.replace(options, **legacy) if legacy else options


def resolve_backend(
    requested: Optional[str],
    supported: bool,
    leaf: Any = None,
    device: Any = "cuda",
    stage: str = "plane",
) -> str:
    """Collapse one stage's backend request to 'host' or 'device'; the one
    place that says what ``"auto"`` means, for encode and decode alike.

    ``supported`` is the stage's envelope check (its ``supports(...)``):
    outside it every request routes to the host, as the reference routes
    it, so bytes never change.  ``"auto"`` has one rule for tensors and one
    for host bytes: a tensor ``leaf`` takes the device when it lies on a
    CUDA device (a CPU tensor stays on the host); host bytes (``leaf``
    None: a byte stream, a file frame, a blob to decode) take the device
    when ``device`` is a CUDA device and a card is present.
    """
    if requested is None or requested == "host":
        return "host"
    if requested == "device":
        return "device" if supported else "host"
    if requested == "auto":
        if isinstance(leaf, torch.Tensor):
            on_card = leaf.is_cuda
        else:
            on_card = torch.device(device).type == "cuda" and torch.cuda.is_available()
        return "device" if supported and on_card else "host"
    raise ValueError(
        f"unknown {stage} backend {requested!r}; expected one of {BACKENDS}"
    )


class ZipNNSession:
    """Bind a :class:`~.zipnn.ZipNNConfig`, a :class:`CodecOptions` and a
    ``device`` once; call the whole codec surface without re-threading
    them.

        session = ZipNNSession(options=CodecOptions(backend="device"))
        manifest = session.compress_pytree(params)
        back = session.decompress_pytree(manifest)

    Every method gives the bytes of the module-level call with the same
    config, options and device: the session only routes.
    """

    def __init__(
        self,
        config: Optional[Any] = None,
        options: CodecOptions = DEFAULT_OPTIONS,
        device: Any = "cuda",
    ) -> None:
        from . import zipnn  # lazy: zipnn imports this module

        self.config = zipnn.DEFAULT if config is None else config
        self.options = options
        self.device = device

    def _opts(self, device_resident: Optional[bool]) -> CodecOptions:
        return resolve_options(self.options, device_resident=device_resident)

    # -- byte streams -------------------------------------------------------
    def compress_bytes(self, raw: Any, dtype_name: str, *, delta: bool = False) -> bytes:
        from . import zipnn

        return zipnn.compress_bytes(
            raw, dtype_name, self.config, delta=delta, options=self.options,
            device=self.device,
        )

    def decompress_bytes(self, blob: bytes) -> bytes:
        from . import zipnn

        return zipnn.decompress_bytes(
            blob, self.config, options=self.options, device=self.device
        )

    # -- tensors / pytrees --------------------------------------------------
    def compress_array(self, arr: Any) -> Any:
        from . import zipnn

        return zipnn.compress_array(arr, self.config, options=self.options, device=self.device)

    def decompress_array(self, ct: Any, *, device_resident: Optional[bool] = None) -> Any:
        from . import zipnn

        return zipnn.decompress_array(
            ct, self.config, options=self._opts(device_resident), device=self.device
        )

    def compress_pytree(self, tree: Any) -> Dict[str, Any]:
        from . import zipnn

        return zipnn.compress_pytree(
            tree, self.config, options=self.options, device=self.device
        )

    def decompress_pytree(
        self, manifest: Dict[str, Any], *, device_resident: Optional[bool] = None
    ) -> Any:
        from . import zipnn

        return zipnn.decompress_pytree(
            manifest, self.config, options=self._opts(device_resident), device=self.device
        )

    # -- deltas (§4.2) ------------------------------------------------------
    def delta_compress(self, new: Any, base: Any) -> Any:
        from . import zipnn

        return zipnn.delta_compress(
            new, base, self.config, options=self.options, device=self.device
        )

    def delta_compress_batched(self, news: Any, bases: Any) -> Any:
        from . import zipnn

        return zipnn.delta_compress_batched(
            news, bases, self.config, options=self.options, device=self.device
        )

    def delta_decompress(
        self, ct: Any, base: Any, *, device_resident: Optional[bool] = None
    ) -> Any:
        from . import zipnn

        return zipnn.delta_decompress(
            ct, base, self.config, options=self._opts(device_resident), device=self.device
        )

    # -- streaming files ----------------------------------------------------
    def compress_file(self, src: Any, dst: Any, dtype_name: str, **kw: Any) -> Any:
        from . import engine

        return engine.compress_file(
            src, dst, dtype_name, self.config, options=self.options, device=self.device, **kw
        )

    def decompress_file(self, src: Any, dst: Any, **kw: Any) -> Any:
        from . import engine

        return engine.decompress_file(
            src, dst, self.config, options=self.options, device=self.device, **kw
        )
