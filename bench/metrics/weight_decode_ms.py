"""Device ms a step of the work launched inside the decode spans (K1, K2
and their copies), summed over the traced steps and divided by them."""


def read(rec):
    t = rec["trace"]
    if not t or not t.get("decode"):
        return None
    return sum(b - a for a, b in t["decode"]) / t["steps"] / 1e3
