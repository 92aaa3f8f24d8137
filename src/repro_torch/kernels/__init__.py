"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper launches its kernel on CUDA tensors and runs its plain
version on CPU tensors, and counts its launches in a ``launches``
attribute (kernel launches only; plain runs are not counted).  K1 has
three launch forms, each counted on its own: ``huffdecode_chunks`` with a
sync index (the serving ring's decode), ``huffdecode_serial`` (the
self-synchronising decode, for one-shot decodes) and ``huffdecode_index``
(the same kernel writing the index, a feed's build); ``huffdecode_chain``
counts the one-thread-a-chunk baseline, which no path runs.
:mod:`.ops` is the public face of K4–K6 and K8–K11, the counterpart of the
reference's ``repro.kernels.ops``; its ``huffman_encode_chunks`` is
exported here as the reference exports it.
"""

from typing import Dict

from .bitpack import (
    bitpack_encode_chunks,
    bitpack_encode_chunks_plain,
    bitpack_encode_chunks_single,
    bitpack_encode_chunks_single_plain,
)
from .bytegroup import (
    bytegroup_bf16,
    bytegroup_bf16_plain,
    bytegroup_fp32,
    bytegroup_fp32_plain,
    ungroup_bf16,
    ungroup_bf16_plain,
    ungroup_fp32,
    ungroup_fp32_plain,
)
from .fused_plane import plane_producer, plane_producer_plain
from .fused_unplane import plane_consumer, plane_consumer_plain
from .histogram import (
    byte_histogram,
    byte_histogram_plain,
    chunk_histogram,
    chunk_histogram_plain,
)
from .huffdecode import (
    huffdecode_chain,
    huffdecode_chain_plain,
    huffdecode_chunks,
    huffdecode_chunks_plain,
    huffdecode_index,
    huffdecode_index_plain,
    huffdecode_selfsync_plain,
    huffdecode_serial,
)
from .xor_delta import xor_delta_u32, xor_delta_u32_plain, xor_elems, xor_elems_plain
from . import fused_plane, fused_unplane, ops
from .ops import huffman_encode_chunks

# Names of the reference's ``repro.kernels.__all__`` the port has no
# counterpart for: ``ref`` is the Pallas kernels' jnp oracle, whose role
# each kernel's plain PyTorch version plays here.
UNPORTED = ("ref",)

__all__ = [
    "KERNELS",
    "UNPORTED",
    "fused_plane",
    "fused_unplane",
    "ops",
    "huffman_encode_chunks",
    "huffdecode_chain",
    "huffdecode_chain_plain",
    "huffdecode_selfsync_plain",
    "bitpack_encode_chunks",
    "bitpack_encode_chunks_plain",
    "bitpack_encode_chunks_single",
    "bitpack_encode_chunks_single_plain",
    "byte_histogram",
    "byte_histogram_plain",
    "bytegroup_bf16",
    "bytegroup_bf16_plain",
    "bytegroup_fp32",
    "bytegroup_fp32_plain",
    "chunk_histogram",
    "chunk_histogram_plain",
    "huffdecode_chunks",
    "huffdecode_chunks_plain",
    "huffdecode_index",
    "huffdecode_index_plain",
    "huffdecode_serial",
    "plane_consumer",
    "plane_consumer_plain",
    "plane_producer",
    "plane_producer_plain",
    "ungroup_bf16",
    "ungroup_bf16_plain",
    "ungroup_fp32",
    "ungroup_fp32_plain",
    "xor_delta_u32",
    "xor_delta_u32_plain",
    "xor_elems",
    "xor_elems_plain",
    "launch_counts",
    "reset_launch_counts",
]

KERNELS = {
    "huffdecode_chunks": huffdecode_chunks,      # the sync decode (the ring's)
    "huffdecode_serial": huffdecode_serial,
    "huffdecode_index": huffdecode_index,
    "huffdecode_chain": huffdecode_chain,        # the baseline; no path launches it
    "plane_consumer": plane_consumer,
    "plane_producer": plane_producer,
    "bitpack_encode_chunks": bitpack_encode_chunks,
    "bytegroup_bf16": bytegroup_bf16,
    "bytegroup_fp32": bytegroup_fp32,
    "xor_elems": xor_elems,
    "chunk_histogram": chunk_histogram,
    "bitpack_encode_chunks_single": bitpack_encode_chunks_single,
    "byte_histogram": byte_histogram,
    "xor_delta_u32": xor_delta_u32,
    "ungroup_bf16": ungroup_bf16,
    "ungroup_fp32": ungroup_fp32,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_path"):     # K2 and K11: launches by kernel path
            fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)
