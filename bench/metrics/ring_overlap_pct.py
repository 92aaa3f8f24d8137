"""Share of the weight decode's device time during which compute work
also runs on the card (device trace; decode is the work launched inside
the decode spans)."""

from harness import arith


def read(rec):
    t = rec["trace"]
    if not t or not t.get("decode"):
        return None
    return 100.0 * arith.overlap(t["decode"], t["compute"]) / arith.length(t["decode"])
