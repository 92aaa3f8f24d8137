"""KV-cache tiering: cold cache blocks live as ZNN1 payloads.

A port of ``repro.serve.kvcache``.  ``KVCacheStore`` tiers a model's
stacked attention caches (GQA ``kv_k`` / ``kv_v``; MLA ``mla_ckv`` /
``mla_kr``) by position:

* the newest ``hot_window`` positions stay in an uncompressed **hot
  buffer** on the caches' device (a stacked suffix, one per cache key);
* once a ``block_len``-aligned block falls entirely behind the hot window
  it is **evicted**: each (key, layer) block compresses to its own ZNN1
  payload with ``zipnn.compress_array``.  A block on a card encodes there
  (K3 planes; K7 packs the Huffman chunks under the canonical coder) and
  only its planes come to the host;
* :meth:`layer_caches` puts one layer's full-length caches back together:
  each cold block through ``decompress_array(device_resident=True)`` (K1's
  one-shot decode and K2 on a card), then the live hot suffix, then a zero
  tail — bit-identical to the slice the untiered ``decode_step`` would
  read (the codec is lossless, and unwritten positions are zeros, as in
  ``init_kv_cache``).

Blobs are byte-identical to the reference's store fed the same entries.
Live hot positions never exceed ``hot_window + block_len``
(``peak_hot_positions``), and decoded cold blocks are in flight only for
the layer being put back together (``peak_inflight_blocks``).  There is
no ring wraparound: tiering needs ``pos < cache length``.  SSM states have
no cache-length axis and are rejected.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core import bitlayout, zipnn
from ..core.options import CodecOptions, resolve_options

__all__ = ["GQA_KEYS", "MLA_KEYS", "KVCacheStore"]

# Stacked attention-cache keys, in block-call order: (c0, c1).  MLA's
# pair holds the latent (B, L, kv_lora_rank) and the shared rope key
# (B, L, qk_rope_dim).
GQA_KEYS: Tuple[str, str] = ("kv_k", "kv_v")
MLA_KEYS: Tuple[str, str] = ("mla_ckv", "mla_kr")


class KVCacheStore:
    """Block-granular compressed tier over stacked attention caches."""

    def __init__(
        self,
        state: Dict[str, Any],
        *,
        hot_window: int = 256,
        block_len: int = 64,
        config: Optional[zipnn.ZipNNConfig] = None,
        options: Optional[CodecOptions] = None,
    ) -> None:
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        if hot_window < 1:
            raise ValueError(f"hot_window must be >= 1, got {hot_window}")
        if "ssm_state" in state:
            raise NotImplementedError("ssm/hybrid decode state has no cache-length axis to tier")
        if all(k in state for k in MLA_KEYS):
            keys = MLA_KEYS
        elif all(k in state for k in GQA_KEYS):
            keys = GQA_KEYS
        else:
            raise ValueError(
                f"state holds no stacked attention caches (need {GQA_KEYS} or {MLA_KEYS})"
            )
        if int(state["pos"]) != 0:
            raise ValueError(
                "tiering starts from an empty cache: build the state with "
                "start_pos=0 and feed the prompt through the tiered step"
            )
        self._config = zipnn.DEFAULT if config is None else config
        self._options = resolve_options(options)
        self.keys = keys
        self.hot_window = hot_window
        self.block_len = block_len
        ref = state[keys[0]]
        self.device = ref.device
        self.n_layers = int(ref.shape[0])
        self.length = int(ref.shape[2])
        # Hot capacity: hot_window live positions plus one block still
        # filling — the moment a full block ages past the window it leaves.
        cap = min(hot_window + block_len, self.length)
        self.hot: Dict[str, torch.Tensor] = {
            k: torch.zeros(
                tuple(state[k].shape[:2]) + (cap,) + tuple(state[k].shape[3:]),
                dtype=state[k].dtype, device=self.device,
            )
            for k in keys
        }
        # cold[key][layer]: one payload per evicted block, in position
        # order; block b covers [b * block_len, (b + 1) * block_len).
        self._cold: Dict[str, List[List[zipnn.CompressedTensor]]] = {
            k: [[] for _ in range(self.n_layers)] for k in keys
        }
        self.pos = 0
        self.cold_len = 0
        self.peak_hot_positions = 0
        self.peak_inflight_blocks = 0

    # -- read path ---------------------------------------------------------

    def layer_caches(self, layer: int) -> Tuple[torch.Tensor, ...]:
        """Layer ``layer``'s full-length caches, ``(c0, c1)``-ordered,
        equal byte for byte to the slices ``decode_step`` reads from the
        untiered stacked cache."""
        return tuple(self._assemble(k, layer) for k in self.keys)

    def _assemble(self, key: str, layer: int) -> torch.Tensor:
        hot = self.hot[key][layer]                      # (B, cap, ...)
        blocks = self._cold[key][layer]
        if blocks:
            self.peak_inflight_blocks = max(self.peak_inflight_blocks, len(blocks))
        parts = [
            zipnn.decompress_array(
                ct, self._config, options=self._options,
                device_resident=True, device=self.device,
            )
            for ct in blocks
        ]
        take = min(hot.shape[1], self.length - self.cold_len)
        parts.append(hot[:, :take])
        pad = self.length - self.cold_len - take
        if pad:
            parts.append(hot.new_zeros(hot.shape[:1] + (pad,) + hot.shape[2:]))
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    # -- write path --------------------------------------------------------

    def append(self, *news: torch.Tensor) -> None:
        """Write one decoded token's stacked new-cache entries.

        ``news`` aligns with :attr:`keys`, each ``(L, B, 1, ...)``: what
        ``decode_step`` hands its single post-loop slot write.  The write is
        the same masked select (at the hot-local slot); then blocks aged
        fully past the hot window evict.
        """
        if self.pos >= self.length:
            raise ValueError(
                f"tiered cache is full at pos={self.pos} (length {self.length}): "
                "no ring wraparound over evicted blocks"
            )
        slot = self.pos - self.cold_len
        for k, new in zip(self.keys, news):
            hot = self.hot[k]
            shape = [1] * hot.dim()
            shape[2] = hot.shape[2]
            idx = torch.arange(hot.shape[2], device=hot.device).reshape(shape)
            self.hot[k] = torch.where(idx == slot, new.to(hot.dtype), hot)
        self.pos += 1
        self.peak_hot_positions = max(self.peak_hot_positions, self.pos - self.cold_len)
        while self.pos - self.cold_len >= self.hot_window + self.block_len:
            self._evict_block()

    def _evict_block(self) -> None:
        bl = self.block_len
        for k in self.keys:
            hot = self.hot[k]
            for j in range(self.n_layers):
                self._cold[k][j].append(
                    zipnn.compress_array(
                        hot[j, :, :bl].contiguous(), self._config,
                        options=self._options, device=self.device,
                    )
                )
            zero = hot.new_zeros(hot.shape[:2] + (bl,) + hot.shape[3:])
            self.hot[k] = torch.cat([hot[:, :, bl:], zero], dim=2)
        self.cold_len += bl

    def cold_blocks(self, key: str, layer: int) -> List[zipnn.CompressedTensor]:
        """The payloads of ``(key, layer)``'s evicted blocks, in position
        order."""
        return list(self._cold[key][layer])

    # -- residency accounting ---------------------------------------------

    @property
    def n_cold_blocks(self) -> int:
        """Evicted blocks per (key, layer) — all chains have equal length."""
        return self.cold_len // self.block_len

    @property
    def hot_bytes(self) -> int:
        """Uncompressed bytes held resident in the hot buffers."""
        return sum(h.numel() * h.element_size() for h in self.hot.values())

    @property
    def cold_comp_bytes(self) -> int:
        """ZNN1 payload bytes held at rest for evicted blocks."""
        return sum(len(ct.blob) for per_layer in self._cold.values()
                   for chain in per_layer for ct in chain)

    @property
    def cold_raw_bytes(self) -> int:
        """What the evicted blocks would occupy uncompressed."""
        return sum(math.prod(ct.shape) * bitlayout.layout_for(ct.dtype).itemsize
                   for per_layer in self._cold.values() for chain in per_layer for ct in chain)

    @property
    def full_cache_bytes(self) -> int:
        """The untiered stacked caches' footprint (the baseline)."""
        per_pos = sum(
            math.prod(h.shape[:2]) * math.prod(h.shape[3:]) * h.element_size()
            for h in self.hot.values()
        )
        return per_pos * self.length

    def resident_bytes(self, inflight_layers: int = 1) -> int:
        """Tiered steady-state footprint: hot buffers + compressed cold
        payloads + ``inflight_layers`` reassembled full-length layers."""
        per_layer = self.full_cache_bytes // max(self.n_layers, 1)
        return self.hot_bytes + self.cold_comp_bytes + inflight_layers * per_layer
