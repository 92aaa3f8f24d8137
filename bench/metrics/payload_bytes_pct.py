"""The store's device bytes for the layer stacks (payloads, LUT rows and
K1's sync index) as a share of the stacks' raw bytes: ZipNN's ratio on the
served weights, read from the store's counters."""


def read(rec):
    c = rec["counters"]
    if not c.get("raw_bytes"):
        return None
    return 100.0 * c["device_payload_bytes"] / c["raw_bytes"]
