"""Host codec (bit layouts, canonical Huffman, chunked planes, ZNN1
container), the ZNS1 file engine, the device encode path (K3 plane
producer, K7 Huffman bit-pack) and the device decode path (K1 Huffman
decode, K2 plane consumer) on PyTorch tensors.

The codec API is re-exported here under the reference's names
(``repro.core.__all__``); the names of that list the port has no
counterpart for yet are in :data:`UNPORTED`."""

from . import (
    bitlayout,
    codec,
    container,
    device_entropy,
    device_plane,
    device_unplane,
    engine,
    huffman,
    options,
    zipnn,
)
from .bitlayout import LAYOUTS, BitLayout, exponent_view, from_planes, layout_for, to_planes
from .codec import CodecParams, Method, ProbeStats, longest_zero_run
from .engine import (
    CompressWriter,
    DecompressReader,
    compress_file,
    decompress_file,
    get_pool,
    resolve_threads,
)
from .zipnn import (
    CompressedTensor,
    ZipNNConfig,
    compress_array,
    compress_bytes,
    compress_pytree,
    decompress_array,
    decompress_bytes,
    decompress_pytree,
    delta_compress,
    delta_compress_batched,
    delta_decompress,
    ratio,
)

# The reference's statistics (``core/stats.py``) and baselines
# (``core/baselines.py``), not ported yet.
UNPORTED = ("byte_entropy", "exponent_histogram", "plane_report", "classify_model", "baselines")

__all__ = [
    "bitlayout",
    "codec",
    "container",
    "device_entropy",
    "device_plane",
    "device_unplane",
    "engine",
    "huffman",
    "options",
    "zipnn",
    "UNPORTED",
    "BitLayout", "LAYOUTS", "layout_for", "to_planes", "from_planes",
    "exponent_view", "CodecParams", "Method", "ProbeStats", "longest_zero_run",
    "CompressWriter", "DecompressReader", "compress_file", "decompress_file",
    "get_pool", "resolve_threads",
    "ZipNNConfig", "CompressedTensor", "compress_array", "decompress_array",
    "compress_bytes", "decompress_bytes", "compress_pytree",
    "decompress_pytree", "delta_compress", "delta_compress_batched",
    "delta_decompress", "ratio",
]
