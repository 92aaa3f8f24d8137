"""Device ms a step of the work launched outside the decode spans: the
model step (front, blocks, cache write, tail) and the token's argmax and
copy, summed over the traced steps and divided by them."""


def read(rec):
    t = rec["trace"]
    if not t or not t.get("steps") or not t.get("compute"):
        return None
    return sum(b - a for a, b in t["compute"]) / t["steps"] / 1e3
