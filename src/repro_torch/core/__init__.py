"""Host codec (bit layouts, canonical Huffman, chunked planes, ZNN1
container), the ZNS1 file engine, the device encode path (K3 plane
producer, K7 Huffman bit-pack) and the device decode path (K1 Huffman
decode, K2 plane consumer) on PyTorch tensors; the compressibility
statistics (K4/K9 counts on the tensor's device) and the baselines ZipNN is
evaluated against.

The codec API is re-exported here under the reference's names
(``repro.core.__all__``); :data:`UNPORTED` lists the names of that list the
port has no counterpart for (none)."""

from . import (
    baselines,
    bitlayout,
    codec,
    container,
    device_entropy,
    device_plane,
    device_unplane,
    engine,
    huffman,
    options,
    stats,
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
from .stats import byte_entropy, classify_model, exponent_histogram, plane_report

UNPORTED = ()

__all__ = [
    "baselines",
    "bitlayout",
    "codec",
    "container",
    "device_entropy",
    "device_plane",
    "device_unplane",
    "engine",
    "huffman",
    "options",
    "stats",
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
    "byte_entropy", "exponent_histogram", "plane_report", "classify_model",
]
