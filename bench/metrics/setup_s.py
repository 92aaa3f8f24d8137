"""Seconds from the start of the process to the window's start: imports,
the weights drawn, the serving entry built, the context drawn, the
warm-up (and on a checkout's first run the kernels' build)."""


def read(rec):
    return rec["setup_s"]
