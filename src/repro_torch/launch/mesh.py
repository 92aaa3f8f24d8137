"""Production meshes as ``DeviceMesh``\\ es.  A port of
``repro.launch.mesh``.

Defined as FUNCTIONS (not module constants), as in the reference, so
importing this module touches no process group: a mesh is built on the
default process group the caller has started (``torch.distributed.
init_process_group``; nothing on the card's machine tells a program of a
cluster, so the caller gives it its store or address, rank and world
size).  :func:`local_process_group` starts the one-process group that
:func:`make_host_mesh` needs and destroys it on exit.
"""

from __future__ import annotations

import contextlib
from typing import Optional

__all__ = [
    "SINGLE_POD",
    "MULTI_POD",
    "make_production_mesh",
    "make_host_mesh",
    "n_chips",
    "local_process_group",
]

SINGLE_POD = (16, 16)                 # 256 chips
MULTI_POD = (2, 16, 16)               # 2 pods × 256 = 512 chips


def _mk(shape, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a started process group of world size {n}: "
                           f"call torch.distributed.init_process_group first")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs world size {n}, the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, over the default process
    group, whose world size must be 256 or 512."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device_type)


def make_host_mesh(*, device_type: str = "cuda"):
    """(1, 1) ``("data", "model")`` mesh of the one process (a process group
    of world size 1, e.g. :func:`local_process_group`)."""
    return _mk((1, 1), ("data", "model"), device_type)


def n_chips(mesh) -> int:
    shape = mesh.shape.values() if isinstance(mesh.shape, dict) else mesh.shape
    n = 1
    for v in shape:
        n *= v
    return n


@contextlib.contextmanager
def local_process_group(backend: Optional[str] = None):
    """A process group of world size 1 over an in-memory store (no
    rendezvous, no socket), destroyed on exit.  ``backend`` defaults to
    ``"nccl"`` where a card is present, else ``"gloo"``."""
    import torch
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
