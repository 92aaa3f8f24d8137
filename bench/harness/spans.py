"""The program's own spans (``repro_torch.trace``) reduced to what the span
readings read.

A traced run holds two recordings of the program's spans: one around the
serving mode's set-up (the store build) and one around the profiled
steps.  From the profiler's events, each device event (kernel, copy or
set) inside the steps' window goes to the innermost program span open on
the thread that launched it, joined to its launch by the correlation id
as :func:`harness.trace.reduce` joins it; an event launched outside every
program span goes under :data:`OUTSIDE`.  From the recordings: host ms a
step by span (inclusive and self), the program's launch and upload
counters a step, and the build's seconds by span.

On a checkout whose program has no ``repro_torch.trace`` (older commits),
:func:`recording` yields None, :func:`reduce` returns None and every
reading is None.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Any, Dict, List, Optional

from . import trace

try:
    from repro_torch import trace as program
except ImportError:
    program = None

OUTSIDE = "(outside the program's spans)"
K1, K2 = "huffdecode_chunks", "plane_consumer"


def recording():
    """A recording of the program's spans (None without the module)."""
    return program.recording() if program is not None else contextlib.nullcontext()


def _innermost(spans, times):
    """For each sorted time, the name of the innermost of ``spans``
    (``(start, end, name)`` of one thread, nested) open at it, or None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def device_us(events: List[Dict], names) -> Dict[str, float]:
    """Device microseconds inside the steps' window by the innermost span
    of ``names`` open on the launching thread at the launch."""
    steps = [trace._span(e) for e in trace._x(events, ("user_annotation",))
             if e["name"] == trace.STEP]
    if not steps:
        return {}
    lo, hi = min(s[0] for s in steps), max(s[1] for s in steps)
    by_thread = defaultdict(list)
    for e in trace._x(events, ("user_annotation",)):
        if e["name"] in names:
            by_thread[(e.get("pid"), e.get("tid"))].append(trace._span(e) + (e["name"],))
    launches = {e["args"]["correlation"]: e for e in trace._x(events, trace.LAUNCH_CATS)
                if "correlation" in e.get("args", {})}
    pending = defaultdict(list)          # thread -> [(launch ts, device us)]
    total: Dict[str, float] = defaultdict(float)
    for e in trace._x(events, trace.DEVICE_CATS):
        if not lo <= float(e["ts"]) <= hi:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            total[OUTSIDE] += float(e.get("dur", 0.0))
            continue
        pending[(launch.get("pid"), launch.get("tid"))].append(
            (float(launch["ts"]), float(e.get("dur", 0.0))))
    for thread, items in pending.items():
        items.sort()
        for (_, dur), name in zip(items, _innermost(by_thread.get(thread, []),
                                                    [t for t, _ in items])):
            total[name or OUTSIDE] += dur
    return dict(total)


def reduce(events: Optional[List[Dict]], steps_rec, build_rec) -> Optional[Dict[str, Any]]:
    """What the span readings read: device and host ms a step by span,
    the counters a step, and the build's seconds by span."""
    if program is None or steps_rec is None or not events:
        return None
    steps = sum(e["name"] == trace.STEP for e in trace._x(events, ("user_annotation",)))
    if not steps:
        return None
    host = {n: {"count": t["count"] / steps, "ms": t["ns"] / steps / 1e6,
                "self_ms": t["self_ns"] / steps / 1e6}
            for n, t in steps_rec.totals.items()}
    build = {n: {"count": t["count"], "s": t["ns"] / 1e9, "self_s": t["self_ns"] / 1e9}
             for n, t in (build_rec.totals.items() if build_rec is not None else ())}
    return {
        "steps": steps,
        "device_ms": {n: us / steps / 1e3
                      for n, us in device_us(events, program.NAMES).items()},
        "host_ms": host,
        "counters": {k: v / steps for k, v in steps_rec.counters.items() if v},
        "build_s": build,
    }


def _device(name):
    return lambda s: s["device_ms"].get(name)


def _step_host(s):
    step = s["host_ms"].get("serve.step")
    if step is None:
        return None
    return step["ms"] - s["host_ms"].get("ring.wait", {"ms": 0.0})["ms"]


def _decode_host(s):
    return s["host_ms"]["feed.decode"]["ms"] if "feed.decode" in s["host_ms"] else None


def _decode_launches(s):
    if "feed.decode" not in s["host_ms"]:
        return None
    return s["counters"].get(K1, 0.0) + s["counters"].get(K2, 0.0)


def _build(name):
    return lambda s: s["build_s"][name]["s"] if name in s["build_s"] else None


READINGS = {
    "attention_ms": _device("model.attention"),
    "mlp_ms": _device("model.mlp"),
    "cache_write_ms": _device("model.write_caches"),
    "step_host_ms": _step_host,
    "decode_host_ms": _decode_host,
    "decode_launches": _decode_launches,
    "build_encode_s": _build("store.encode"),
    "build_feed_s": _build("store.feed"),
}


def read(rec: Dict[str, Any], name: str):
    """Reading ``name`` of a run's records, None where its span or
    counter has nothing (or the checkout's program has no spans)."""
    s = rec.get("spans")
    return READINGS[name](s) if s else None
