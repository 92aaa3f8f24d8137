"""The traced run: one ``torch.profiler`` window over steps of the timed
loop, the benchmark's own spans, and the reduction of the trace to what
the per-layer metrics read.

Spans are ``record_function`` ranges the benchmark opens itself: one
around each step (:data:`STEP`) and, where the serving mode decodes
weights, one around each decode call (:data:`DECODE`).  A device event
(kernel, copy or set) belongs to the decode when the host call that
launched it (joined through the profiler's correlation id) lies inside a
decode span on the same thread, and to the compute otherwise.  An event
whose launch the trace does not hold is attributed by its stream: to the
decode when that stream carries decode work and no compute, else to the
compute; ``unattributed`` counts them.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Any, Callable, Dict, List

from . import arith

STEP = "bench.step"
DECODE = "bench.decode"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
TOP = 10


def profile_steps(step: Callable[[], Any], steps: int, instrument: Callable) -> List[Dict]:
    """Run ``steps`` calls of ``step`` under the profiler, each in a
    :data:`STEP` span, with the mode's decode calls in :data:`DECODE`
    spans (``instrument(span)`` wraps them and returns an undo); the
    trace's events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    undo = instrument(lambda: record_function(DECODE))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                with record_function(STEP):
                    step()
    finally:
        undo()
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _x(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def reduce(events: List[Dict]) -> Dict[str, Any]:
    """What the per-layer metrics read, in microseconds: the step spans,
    the device intervals split into decode and compute, device time by
    op, idle gaps by what the host was doing, the busy time and window."""
    steps = sorted(_span(e) for e in _x(events, ("user_annotation",)) if e["name"] == STEP)
    if not steps:
        return {"steps": 0}
    lo, hi = steps[0][0], steps[-1][1]
    decode_spans = defaultdict(list)
    for e in _x(events, ("user_annotation",)):
        if e["name"] == DECODE:
            decode_spans[(e.get("pid"), e.get("tid"))].append(_span(e))
    starts = {k: sorted(v) for k, v in decode_spans.items()}
    launches = {e["args"]["correlation"]: e for e in _x(events, LAUNCH_CATS)
                if "correlation" in e.get("args", {})}

    def in_decode(launch) -> bool:
        spans = starts.get((launch.get("pid"), launch.get("tid")), [])
        t = float(launch["ts"])
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]

    device = [e for e in _x(events, DEVICE_CATS) if lo <= float(e["ts"]) <= hi]
    side: Dict[str, List] = {"decode": [], "compute": []}
    loose = []
    streams = defaultdict(set)
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            loose.append(e)
            continue
        kind = "decode" if in_decode(launch) else "compute"
        side[kind].append(_span(e))
        streams[e.get("args", {}).get("stream")].add(kind)
    for e in loose:
        kinds = streams.get(e.get("args", {}).get("stream"), set())
        side["decode" if kinds == {"decode"} else "compute"].append(_span(e))
    all_iv = [_span(e) for e in device]
    by_op: Dict[str, float] = defaultdict(float)
    for e in device:
        by_op[e["name"][:120]] += float(e.get("dur", 0.0))
    busy = arith.length(arith.clip(all_iv, lo, hi))
    return {
        "steps": len(steps),
        "step_spans": steps,
        "window": (lo, hi),
        "decode": side["decode"],
        "compute": side["compute"],
        "busy_us": busy,
        "window_us": hi - lo,
        "unattributed": len(loose),
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": _idle_by_host(events, all_iv, lo, hi),
    }


def _idle_by_host(events, device_iv, lo, hi):
    """Idle device time summed by the innermost host event running at the
    middle of each gap (the step thread's), the largest first."""
    thread = None
    for e in _x(events, ("user_annotation",)):
        if e["name"] == STEP:
            thread = (e.get("pid"), e.get("tid"))
            break
    host = sorted((_span(e) + (e["name"],) for e in _x(events, HOST_CATS)
                   if (e.get("pid"), e.get("tid")) == thread), key=lambda s: s[0])
    starts = [s[0] for s in host]
    total: Dict[str, float] = defaultdict(float)
    for a, b in arith.gaps(device_iv, lo, hi):
        mid = (a + b) / 2
        name = "(no host event)"
        # host events nest on one thread: the innermost one around ``mid``
        # is the latest-starting one that has not ended
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        total[name[:120]] += b - a
    return sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
