"""The 95th percentile (nearest rank), over every step of the window, of
the host-clock time between one step's tokens reaching the host and the
next step's, in ms.  Every sequence of the batch sees this gap."""

import math


def read(rec):
    gaps = sorted(rec["window"]["gaps_s"])
    if not gaps:
        return None
    return 1e3 * gaps[math.ceil(0.95 * len(gaps)) - 1]
