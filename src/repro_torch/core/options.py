"""Codec options: one frozen bag for the knobs every entry point takes.

:class:`CodecOptions` rides an ``options=`` keyword on every codec entry
point of :mod:`.zipnn` and on the serving store:

    opts = CodecOptions(threads=-1)
    blob = zipnn.compress_bytes(raw, "bfloat16", options=opts)

``None`` fields mean "defer to the ``ZipNNConfig``".  ``threads`` never
changes bytes.  ``device_resident`` is a semantic flag: it changes what a
decode entry point returns (a tensor on the entry point's ``device``
instead of a CPU tensor).  The reference's ``backend`` /
``entropy_backend`` knobs select device encode stages, which this package
does not have yet; they join the bag with those stages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["CodecOptions", "DEFAULT_OPTIONS", "resolve_options"]


@dataclasses.dataclass(frozen=True)
class CodecOptions:
    """Per-call codec knobs.

    threads:          0/1 serial, N>1 pool workers, -1 all cores.
    device_resident:  decode paths only — return restored leaves on the
                      entry point's ``device``.
    """

    threads: Optional[int] = None
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
