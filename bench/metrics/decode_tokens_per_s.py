"""Tokens decoded per second: batch × the steps whose tokens reached the
host inside the window, over the window's seconds (host clock)."""


def read(rec):
    w = rec["window"]
    return rec["batch"] * w["steps"] / w["seconds"]
