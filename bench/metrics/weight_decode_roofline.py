"""The least time a step's weight decode could take, over the device time
it took (the decode spans' work a step, as ``weight_decode_ms``): every
payload byte held for the stacks read once and every decoded byte written
once, at the card's HBM bandwidth.  Bytes only, so the same work counts
whatever kernels do it."""

from harness import arith


def read(rec):
    t, c = rec["trace"], rec["counters"]
    if not t or not t.get("decode") or not c.get("raw_bytes"):
        return None
    took_s = sum(b - a for a, b in t["decode"]) / t["steps"] / 1e6
    least_s = arith.weight_decode_bytes(c["device_payload_bytes"], c["raw_bytes"]) \
        / arith.PEAKS["hbm_bytes_per_s"]
    return 100.0 * least_s / took_s
