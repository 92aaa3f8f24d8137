"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper launches its kernel on CUDA tensors and runs its plain
version on CPU tensors, and counts its launches in a ``launches``
attribute (kernel launches only; plain runs are not counted).
"""

from typing import Dict

from .bitpack import bitpack_encode_chunks, bitpack_encode_chunks_plain
from .fused_plane import plane_producer, plane_producer_plain
from .fused_unplane import plane_consumer, plane_consumer_plain
from .huffdecode import huffdecode_chunks, huffdecode_chunks_plain

__all__ = [
    "KERNELS",
    "bitpack_encode_chunks",
    "bitpack_encode_chunks_plain",
    "huffdecode_chunks",
    "huffdecode_chunks_plain",
    "plane_consumer",
    "plane_consumer_plain",
    "plane_producer",
    "plane_producer_plain",
    "launch_counts",
    "reset_launch_counts",
]

KERNELS = {
    "huffdecode_chunks": huffdecode_chunks,
    "plane_consumer": plane_consumer,
    "plane_producer": plane_producer,
    "bitpack_encode_chunks": bitpack_encode_chunks,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
