"""Chunk scheduler: shared thread pools for the codec's work items.

Every (plane, chunk) work item of the codec is independent, and payloads
are byte-aligned per chunk, so fanning them across a pool changes
wall-clock only: output bytes are identical for any thread count.  The
streaming file engine (ZNS1) is not part of this package yet.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

__all__ = ["resolve_threads", "get_pool"]


def resolve_threads(threads: Optional[int]) -> int:
    """Normalize the ``threads`` knob: 0/1/None → serial, -1 → all cores.

    Requests beyond the core count are capped: the work items are CPU-bound
    (zlib/numpy), so extra workers only add context-switch and GIL churn.
    """
    if threads is None or threads == 0 or threads == 1:
        return 1
    cores = os.cpu_count() or 1
    if threads < 0:
        return cores
    return min(threads, cores)


_pools: Dict[int, ThreadPoolExecutor] = {}
_pools_lock = threading.Lock()


def get_pool(threads: Optional[int]) -> Optional[ThreadPoolExecutor]:
    """Shared executor for ``threads`` workers, or None for the serial path.

    Pools are cached per worker count for the life of the process: codec
    calls are frequent (every tensor of a pytree) and executor start-up is
    not free.  Idle pooled threads cost nothing while blocked on the queue.
    """
    n = resolve_threads(threads)
    if n <= 1:
        return None
    with _pools_lock:
        pool = _pools.get(n)
        if pool is None:
            pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix=f"zipnn-{n}"
            )
            _pools[n] = pool
        return pool
