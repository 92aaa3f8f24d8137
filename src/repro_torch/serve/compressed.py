"""Compressed-resident serving store: weights at rest stay ZNN1 payloads.

``CompressedParamStore`` splits a model's parameter tree along the
stacked-layer leading axis into per-layer subtrees and compresses each
one into ZNN1 payloads (one :func:`~repro_torch.core.zipnn.
compress_pytree` manifest per layer).  With ``options.backend="device"``
the build encodes on the store's device: K3 planes each layer's
card-resident leaves in place (one launch per layer and dtype) and K7
packs their Huffman chunks, so no leaf goes to the host as raw values;
the payloads are byte-identical to a host build.  Non-stacked params — embed, final
norm, lm head, learned positions, a front end's ``frontend_proj`` — are
the ``static`` residue: touched every token, they
stay uncompressed on the store's device.

``decode_layer`` restores one layer on the store's device.  With
``payload_feed=True`` every leaf's payloads are parsed, checked and
uploaded once at build (:func:`~repro_torch.core.zipnn.build_array_feed`),
and each decode re-runs the Huffman decode (K1) and the plane consumer
(K2) from those resident buffers with no payload upload.  Otherwise a
decode goes through ``decompress_pytree(device_resident=True)``.  The
ring scheduler (:func:`repro_torch.serve.step.make_compressed_serve_step`)
drives decode/release; the store keeps the residency accounting:
``resident_count`` / ``peak_resident`` count decoded-layer slots claimed
now / ever, which the "at most ``ring`` decoded layers" claim checks.
``decode_layer_tile`` / ``release_tile`` decode and release a layer in
``tiles`` contiguous groups of leaves, and then count tile slots.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .. import _util, trace
from ..core import codec, zipnn
from ..core.options import CodecOptions, resolve_options

__all__ = ["DEFAULT_STACK_KEYS", "CompressedParamStore"]

PyTree = Any

# Stacked-layer top-level keys (leading axis = layer), the reference's:
# the dense and SSM families' one stack and the MoE family's two.  A
# hybrid model's stacks (``mamba_groups``, ``mamba_tail``) and its
# ``shared_attn`` are not among them: they stay in ``static``, as in the
# reference.
DEFAULT_STACK_KEYS: Tuple[str, ...] = ("layers", "dense_layers", "moe_layers")


class CompressedParamStore:
    """Per-layer ZNN1 payloads at rest + decoded-slot residency accounting."""

    def __init__(
        self,
        config: Optional[zipnn.ZipNNConfig] = None,
        *,
        options: Optional[CodecOptions] = None,
        threads: Optional[int] = None,
        backend: Optional[str] = None,
        entropy_backend: Optional[str] = None,
        payload_feed: bool = False,
        device: Any = "cuda",
    ) -> None:
        self.device = _util.resolve_device(device)
        self._config = zipnn.DEFAULT if config is None else config
        self._options = resolve_options(
            options, threads=threads, backend=backend, entropy_backend=entropy_backend
        )
        self.payload_feed = payload_feed
        self.static: Dict[str, PyTree] = {}
        self._stacks: Dict[str, List[Dict[str, Any]]] = {}
        # payload_feed=True: per-layer, per-leaf ArrayFeeds (None where a
        # leaf is feed-ineligible and rides the per-call decode instead).
        self._feeds: Dict[str, List[List[Optional[zipnn.ArrayFeed]]]] = {}
        self._lock = threading.Lock()
        self._resident: set = set()
        self.peak_resident = 0

    # -- construction -----------------------------------------------------

    @classmethod
    def from_params(
        cls,
        params: Mapping[str, PyTree],
        config: Optional[zipnn.ZipNNConfig] = None,
        *,
        options: Optional[CodecOptions] = None,
        threads: Optional[int] = None,
        backend: Optional[str] = None,
        entropy_backend: Optional[str] = None,
        payload_feed: bool = False,
        device: Any = "cuda",
    ) -> "CompressedParamStore":
        """Compress ``params``' stacked-layer subtrees into a store.

        Every top-level key of ``params`` in :data:`DEFAULT_STACK_KEYS` is
        split along its leading layer axis and compressed per layer;
        everything else is copied to ``device`` as
        ``store.static``.  ``options.backend`` / ``entropy_backend`` choose
        where the encode runs (the device ones on ``device``).
        Compression is deterministic: two stores built from the same params
        hold byte-identical payloads for any ``threads`` × ``backend`` ×
        ``entropy_backend``.
        """
        if not isinstance(params, Mapping):
            raise ValueError("from_params expects the model's top-level param dict")
        opts = resolve_options(
            options, threads=threads, backend=backend, entropy_backend=entropy_backend
        )
        store = cls(config, options=opts, payload_feed=payload_feed, device=device)
        for key, sub in params.items():
            if key not in DEFAULT_STACK_KEYS:
                store.static[key] = _util.tree_map(lambda a: a.to(store.device), sub)
                continue
            leaves = _util.tree_leaves(sub)
            if not leaves:
                continue
            n = leaves[0].shape[0]
            store._stacks[key] = [store._encode(sub, i) for i in range(n)]
            if payload_feed:
                store._feeds[key] = [store._feed(m) for m in store._stacks[key]]
        return store

    def _encode(self, stack: PyTree, i: int) -> Dict[str, Any]:
        """Layer ``i`` of ``stack`` as one ``compress_pytree`` manifest."""
        with trace.span("store.encode"):
            return zipnn.compress_pytree(
                _util.tree_map(lambda a: a[i], stack), self._config,
                options=self._options, device=self.device,
            )

    def _feed(self, manifest: Dict[str, Any]) -> List[Optional[zipnn.ArrayFeed]]:
        """One layer's per-leaf feeds (None where a leaf rides the per-call
        decode)."""
        with trace.span("store.feed"):
            return [
                zipnn.build_array_feed(ct, self._config, options=self._options,
                                       device=self.device)
                for ct in manifest["leaves"]
            ]

    # -- decode / residency ------------------------------------------------

    def _decode_leaf(self, key: str, i: int, j: int) -> Any:
        """Leaf ``j`` of layer ``i`` on the store's device: from its feed
        where one covers it, by a per-call decode otherwise; bit-identical
        either way."""
        feeds = self._feeds.get(key)
        feed = feeds[i][j] if feeds is not None else None
        if feed is not None:
            return feed.decode()
        return zipnn.decompress_array(
            self._stacks[key][i]["leaves"][j], self._config, options=self._options,
            device_resident=True, device=self.device,
        )

    def decode_layer(self, key: str, i: int) -> PyTree:
        """Decode layer ``i`` of stack ``key`` into a ring slot on the
        store's device (feed path where a feed covers a leaf, per-call
        decode otherwise; bit-identical either way).  Marks the slot
        resident — the caller owns it until :meth:`release`."""
        manifest = self._stacks[key][i]
        if key in self._feeds:
            arrays = [self._decode_leaf(key, i, j) for j in range(len(manifest["leaves"]))]
            tree = _util.tree_unflatten(manifest["treedef"], arrays)
        else:
            tree = zipnn.decompress_pytree(
                manifest, self._config, options=self._options,
                device_resident=True, device=self.device,
            )
        with self._lock:
            self._resident.add((key, i))
            self.peak_resident = max(self.peak_resident, len(self._resident))
        return tree

    def release(self, key: str, i: int) -> None:
        """Return a decoded slot to the ring (drops the store's claim; the
        buffers themselves are freed once the layer's compute is done)."""
        with self._lock:
            self._resident.discard((key, i))

    # -- per-tile decode ---------------------------------------------------

    def n_leaves(self, key: str) -> int:
        """Leaves per layer of stack ``key`` (the same in every layer)."""
        return len(self._stacks[key][0]["leaves"])

    def tile_leaf_ids(self, key: str, t: int, tiles: int) -> range:
        """Leaf indices of tile ``t`` when a layer splits into ``tiles``
        contiguous groups of leaves (``codec.split_ids`` geometry: trailing
        tiles are empty when a layer has fewer leaves than tiles)."""
        ranges = codec.split_ids(self.n_leaves(key), tiles)
        return ranges[t] if t < len(ranges) else range(0)

    def decode_layer_tile(self, key: str, i: int, t: int, tiles: int) -> Dict[int, Any]:
        """Decode tile ``t`` of layer ``i``: ``{leaf_index: tensor}`` for
        the tile's leaves (empty for a trailing empty tile).  Marks one
        *tile slot* resident, so ``peak_resident`` counts tiles: a ring of
        ``ring`` layers split ``tiles`` ways holds at most ``ring × tiles``
        tile slots.  The layer put back together (:meth:`layer_unflatten`)
        is leaf for leaf :meth:`decode_layer`'s."""
        arrays = {j: self._decode_leaf(key, i, j) for j in self.tile_leaf_ids(key, t, tiles)}
        with self._lock:
            self._resident.add((key, i, t, tiles))
            self.peak_resident = max(self.peak_resident, len(self._resident))
        return arrays

    def release_tile(self, key: str, i: int, t: int, tiles: int) -> None:
        """Tile twin of :meth:`release`."""
        with self._lock:
            self._resident.discard((key, i, t, tiles))

    def layer_unflatten(self, key: str, i: int, arrays: List[Any]) -> PyTree:
        """A layer's tree from its decoded leaves, in leaf order."""
        return _util.tree_unflatten(self._stacks[key][i]["treedef"], arrays)

    @property
    def resident_count(self) -> int:
        with self._lock:
            return len(self._resident)

    def reset_peak(self) -> None:
        with self._lock:
            self._resident.clear()
            self.peak_resident = 0

    # -- introspection -----------------------------------------------------

    @property
    def stack_keys(self) -> Tuple[str, ...]:
        return tuple(self._stacks)

    def n_layers(self, key: str) -> int:
        return len(self._stacks.get(key, ()))

    def feeds(self, key: str) -> List[List[Optional[zipnn.ArrayFeed]]]:
        """Per-layer, per-leaf feeds of stack ``key`` (empty without
        ``payload_feed``)."""
        return self._feeds.get(key, [])

    def manifest(self, key: str, i: int) -> Dict[str, Any]:
        return self._stacks[key][i]

    @property
    def raw_bytes(self) -> int:
        """Uncompressed size of the compressed-at-rest stacks."""
        return sum(m["raw_bytes"] for ms in self._stacks.values() for m in ms)

    @property
    def comp_bytes(self) -> int:
        """ZNN1 payload size actually held at rest."""
        return sum(m["comp_bytes"] for ms in self._stacks.values() for m in ms)

    @property
    def ratio_pct(self) -> float:
        return 100.0 * self.comp_bytes / max(1, self.raw_bytes)

    @property
    def device_payload_bytes(self) -> int:
        """Device bytes held by the payload feeds — payload words, splice,
        LUT rows and per-chunk index arrays (0 without ``payload_feed``:
        payloads then live on the host at rest)."""
        return sum(
            feed.device_bytes
            for layers in self._feeds.values()
            for per_leaf in layers
            for feed in per_leaf
            if feed is not None
        )

    @property
    def static_bytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for sub in self.static.values()
            for t in _util.tree_leaves(sub)
        )

    @property
    def max_layer_raw_bytes(self) -> int:
        """Decoded size of the largest single layer — one ring slot."""
        return max(
            (m["raw_bytes"] for ms in self._stacks.values() for m in ms),
            default=0,
        )

    def footprint_bytes(self, ring: int = 2) -> int:
        """Serving-time weight footprint: payloads at rest + static residue
        + ``ring`` decoded-layer slots (vs ``raw_bytes + static_bytes``
        for the uncompressed model).  With ``payload_feed`` the payloads
        at rest are what the feeds hold on the device
        (:attr:`device_payload_bytes`); without it, the ZNN1 blobs."""
        at_rest = self.device_payload_bytes if self._feeds else self.comp_bytes
        return at_rest + self.static_bytes + ring * self.max_layer_raw_bytes
