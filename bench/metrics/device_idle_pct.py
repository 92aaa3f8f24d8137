"""Share of an untraced step in which no kernel, copy or set runs on the
card: one minus the device's busy time a traced step (the union of the
device intervals over the traced steps, divided by their number) over the
mean step time of the same run's untraced window (host clock).  The
profiler's host overhead lengthens a traced step, so the traced window's
own idle share (``busy_s`` against ``window_s`` in the result's
``device``) reads high; the card's work a step does not move with it.
Where the card works through the whole untraced step this reads about 0,
and can read a little below it: the profiler lengthens the card's own
work slightly."""


def read(rec):
    t, w = rec["trace"], rec["window"]
    if not t or not t.get("steps") or not w["steps"] or not w["gaps_s"]:
        return None
    step_s = sum(w["gaps_s"]) / len(w["gaps_s"])
    return 100.0 * (1.0 - t["busy_us"] / 1e6 / t["steps"] / step_s)
