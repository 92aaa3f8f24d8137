"""The whole step's share of the card's dense bf16 peak: model FLOPs of
the window's steps (two per weight applied and the attention over the
cache, from the configuration's numbers) over the window's seconds
(host clock) × 989 TFLOP/s."""

from harness import arith


def read(rec):
    w = rec["window"]
    if not w["steps"]:
        return None
    return 100.0 * rec["flops"] / (w["seconds"] * arith.PEAKS["bf16_flops_per_s"])
