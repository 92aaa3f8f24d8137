"""The card's allocated bytes at their peak over the window
(``torch.cuda.max_memory_allocated``, reset at the window's start), in GB
of 1e9 bytes."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec["peak_bytes"] else None
