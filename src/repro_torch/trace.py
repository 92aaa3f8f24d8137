"""Spans at the layer boundaries of the serving path and the store build.

``with span("feed.decode"): ...`` bounds one piece of the program's work.
Off, the default, ``span`` returns one shared no-op object after a single
check (is a recording open, or is the torch profiler on?): it allocates
and records nothing.  While the profiler is on, the span is also a
``record_function`` range, a ``user_annotation`` event in the profiler's
own trace, on the clock of the kernels and copies it launches.  While a
:func:`recording` is open, the span is kept in memory with
``time.perf_counter_ns``: ``(name, parent, thread, start_ns, end_ns)``,
the parent being the innermost span open on the same thread (a pool
thread's spans have none of the caller's).

Every name is one of :data:`NAMES`.  A recording also keeps each name's
count, inclusive and self nanoseconds (the duration less what the span's
children on its thread cover), and the change, from open to close, of the
counters the program already keeps: ``kernels.launch_counts()`` and
``device_entropy.transfer_stats()``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

__all__ = ["NAMES", "Recording", "recording", "span"]

NAMES: Tuple[str, ...] = (
    "serve.step",          # the host's enqueue of one decode step
    "ring.decode",         # one layer's (or tile's) decode enqueue on the side stream
    "ring.wait",           # the host blocked until the card passes a computed layer
    "feed.decode",         # one leaf's splice copies, K1 and K2
    "model.front",         # embed and positions
    "model.attention",     # a layer's norm and attention over its cache
    "model.mlp",           # a layer's norm, MLP or experts, residual add
    "model.write_caches",  # the step's one cache write
    "model.tail",          # final norm and unembed
    "store.encode",        # one layer's encode (compress_pytree)
    "store.feed",          # one layer's feed build (build_array_feed per leaf)
    "encode.planes",       # K3 and the planes' download
    "encode.plan",         # the host's probe and table build
    "encode.k7",           # K7 launches and their downloads
    "encode.finalize",     # host chunks, expansion guard, metadata
    "feed.verify",         # payload CRCs and the Huffman jobs' checks
    "feed.pack",           # LUT rows and K1's word layout
    "feed.upload",         # the feed's host-to-device copies
    "feed.index",          # K1's index pass and its cursor check
)

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled
_recordings: Tuple["Recording", ...] = ()      # replaced whole, never mutated
_open_lock = threading.Lock()
_local = threading.local()


class Recording:
    """The spans and per-name totals of one :func:`recording`."""

    def __init__(self) -> None:
        self.spans: List[Tuple[str, Optional[str], int, int, int]] = []
        self.totals: Dict[str, Dict[str, int]] = {}
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _add(self, name, parent, thread, t0, t1, self_ns) -> None:
        with self._lock:
            self.spans.append((name, parent, thread, t0, t1))
            tot = self.totals.setdefault(name, {"count": 0, "ns": 0, "self_ns": 0})
            tot["count"] += 1
            tot["ns"] += t1 - t0
            tot["self_ns"] += self_ns


class _Span:
    __slots__ = ("name", "rf", "recs", "frame", "t0")

    def __init__(self, name: str) -> None:
        if name not in NAMES:
            raise ValueError(f"trace: unknown span {name!r}")
        self.name = name

    def __enter__(self) -> None:
        self.rf = None
        if _profiling():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.recs = _recordings
        if self.recs:
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            self.frame = [self.name, 0]                # name, children's ns
            stack.append(self.frame)
            self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        if self.recs:
            t1 = time.perf_counter_ns()
            stack = _local.stack
            stack.pop()
            dur = t1 - self.t0
            parent = None
            if stack:
                stack[-1][1] += dur
                parent = stack[-1][0]
            thread = threading.get_ident()
            for rec in self.recs:
                rec._add(self.name, parent, thread, self.t0, t1, dur - self.frame[1])
        if self.rf is not None:
            self.rf.__exit__(*exc)


def span(name: str):
    """A context manager bounding one piece of work named ``name``."""
    if not _recordings and not _profiling():
        return _OFF
    return _Span(name)


def _counters() -> Dict[str, int]:
    from .core import device_entropy
    from .kernels import launch_counts

    return {**launch_counts(), **device_entropy.transfer_stats()}


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every span opened, on any thread, until the block ends."""
    global _recordings
    rec = Recording()
    before = _counters()
    with _open_lock:
        _recordings = _recordings + (rec,)
    try:
        yield rec
    finally:
        with _open_lock:
            _recordings = tuple(r for r in _recordings if r is not rec)
        after = _counters()
        rec.counters = {k: after[k] - before.get(k, 0) for k in after}
