"""The yardstick's arithmetic: the card's peaks, the bytes a weight decode
must move, and unions of time intervals.  A family's model FLOPs are its
reference's (``reference/<family>.py`` ``decode_flops``).

Counts come from the configuration's numbers alone, not from the program:
a later change to the program cannot move them.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

# NVIDIA H100 SXM, published dense peaks at the full 700 W power limit.
PEAKS = {
    "bf16_flops_per_s": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Disjoint sorted intervals covering the same time."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def overlap(xs: Iterable[Interval], ys: Iterable[Interval]) -> float:
    """Time covered by both sets of intervals."""
    u, v = union(xs), union(ys)
    i = j = 0
    total = 0.0
    while i < len(u) and j < len(v):
        a, b = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
        if b > a:
            total += b - a
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return total


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def weight_decode_bytes(payload_bytes: int, raw_bytes: int) -> int:
    """The least bytes a step's weight decode moves: every payload byte
    held for the stacks read once, every decoded byte written once."""
    return payload_bytes + raw_bytes
