"""Host codec (bit layouts, canonical Huffman, chunked planes, ZNN1
container), the ZNS1 file engine, the device encode path (K3 plane
producer, K7 Huffman bit-pack) and the device decode path (K1 Huffman
decode, K2 plane consumer) on PyTorch tensors."""

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
]
