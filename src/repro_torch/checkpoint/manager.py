"""ZipNN-compressed checkpointing with delta chains and periodic bases.

The paper's §2.1.3/§4.2 use case as a subsystem:

* every checkpoint is ZipNN-compressed per tensor;
* between periodic **bases** (every ``base_every`` saves), tensors are
  stored as XOR **deltas against the last base**, so a restore reads at
  most a base and one delta (§4.2 "Periodic Base");
* **optimizer moments** (AdamW ``m``/``v`` trees, the fp32 bulk of a
  mixed-precision checkpoint) are stored as deltas **against the previous
  save** (``delta_prev``): moments are EMAs, so step-over-step deltas are
  sparser.  Bases store moments in full, which bounds the chain at
  ``base_every`` links; a restore memoises each save it reads, so a chain
  of k saves loads each one once;
* §4.2 picks Huffman or LZ per chunk of each delta;
* saves are **async** (compression and IO off the training thread),
  **atomic** (written under ``.tmp_step_N``, both files fsync'd, then
  ``os.replace`` to ``step_N``: a crash leaves no directory a restore
  accepts) and **CRC-checked** on restore, which falls back to the newest
  valid save.

On the card: ``save`` snapshots each leaf with a copy on the leaf's own
device before it returns (PyTorch optimizers update in place), and the
save thread waits on an event recorded after those copies on the caller's
stream before it reads them, on a stream of its own.  The last base and
the previous save's moments stay where the leaves are, so K3 fuses the XOR
against a card-resident base; a card save runs K3 and K7, a card restore
K1 and K2 (:mod:`repro_torch.core.zipnn`).  ``shard_restore`` restores
onto a ``DeviceMesh``: the restore leaves every leaf on the config's
device, and ``distributed.sharding.device_put_tree`` lays it out as DTensors
there, so on the card only compressed bytes cross host → device and
nothing comes back.

Checkpoint bytes (``manifest.json`` and ``data.bin`` of every step) equal
the reference implementation's (``repro.checkpoint.manager``) for the
same state, and each restores the other's directories.

Layout:  <dir>/step_<N>/{manifest.json, data.bin}
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _util
from ..core import zipnn
from ..core.options import CodecOptions
from ..distributed import sharding
from ..optim.adamw import MOMENT_KEYS, is_moment_path

__all__ = ["CheckpointConfig", "CheckpointManager"]

PyTree = Any
Flat = Dict[str, torch.Tensor]


@dataclasses.dataclass
class CheckpointConfig:
    directory: str
    base_every: int = 5              # every k-th save is a full base (§4.2)
    keep_bases: int = 2              # retention: bases (+ their deltas)
    async_save: bool = True
    # Engine workers for per-tensor (plane, chunk) work items: 0/1 serial,
    # N > 1 pool workers, -1 all cores.
    threads: int = 0
    # Plane-stage backend 'host' | 'device' | 'auto' (the codec's default);
    # 'device' also routes the entropy stage to the card.  Checkpoint bytes
    # are identical for every setting.
    backend: str = "auto"
    # Entropy-stage override for mixed mode (None follows `backend`).
    entropy_backend: Optional[str] = None
    # The knob bag: non-None fields fold into the three fields above (which
    # win when set), then everything folds into the carried ZipNNConfig.
    options: Optional[CodecOptions] = None
    # Flat-key prefixes treated as optimizer moments (delta_prev chains);
    # () disables moment chaining.
    moment_keys: Tuple[str, ...] = MOMENT_KEYS
    zipnn: zipnn.ZipNNConfig = dataclasses.field(default_factory=zipnn.ZipNNConfig)
    # Where the card stages run and where device_resident restores land.
    device: Any = "cuda"

    def __post_init__(self) -> None:
        if self.options is not None:
            if self.options.threads is not None and not self.threads:
                self.threads = self.options.threads
            if self.options.backend is not None and self.backend == "auto":
                self.backend = self.options.backend
            if self.options.entropy_backend is not None and self.entropy_backend is None:
                self.entropy_backend = self.options.entropy_backend
        if self.threads and not self.zipnn.threads:
            self.zipnn = dataclasses.replace(self.zipnn, threads=self.threads)
        if self.backend != "auto" and self.zipnn.plane_backend == "auto":
            self.zipnn = dataclasses.replace(self.zipnn, plane_backend=self.backend)
        if self.entropy_backend is not None and self.zipnn.entropy_backend is None:
            self.zipnn = dataclasses.replace(self.zipnn, entropy_backend=self.entropy_backend)


def _snapshot(leaf: Any) -> torch.Tensor:
    """A copy of one leaf that later in-place updates cannot reach, on the
    leaf's device.  Python and numpy scalars become tensors, as numpy makes
    them (an int is int64)."""
    if isinstance(leaf, torch.Tensor):
        return torch.clone(leaf.detach(), memory_format=torch.contiguous_format)
    return torch.from_numpy(np.array(leaf))


def _flatten(tree: PyTree) -> Flat:
    return {key: _snapshot(leaf) for key, leaf in _util.tree_flatten_with_keys(tree)}


def _unflatten(flat: Flat) -> PyTree:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _same_shape(a: torch.Tensor, b: torch.Tensor) -> bool:
    return tuple(a.shape) == tuple(b.shape)


class CheckpointManager:
    def __init__(self, config: CheckpointConfig):
        self.cfg = config
        os.makedirs(config.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._save_count = 0
        self._last_base_step: Optional[int] = None
        self._last_base_flat: Optional[Flat] = None
        # The previous save's moments and step, kept where the leaves are.
        # Lost on restart: the next save then stores moments vs-base/full,
        # so chains never span a process restart.
        self._last_save_step: Optional[int] = None
        self._last_moment_flat: Optional[Flat] = None
        self._errors: List[BaseException] = []
        for step, kind, base in self._scan():           # resume bookkeeping
            self._save_count += 1
            if kind == "base":
                self._last_base_step = step

    # ------------------------------------------------------------------ save

    def _after_snapshot(self, flat: Flat) -> Optional[torch.cuda.Event]:
        """An event on the caller's stream after the snapshot's copies when
        any leaf is on a card (the save thread's stream waits on it), and
        the save stream recorded on every card leaf so the allocator never
        hands its memory out while that stream may still read it."""
        cuda = [t for t in flat.values() if t.is_cuda]
        if not cuda:
            return None
        dev = cuda[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        for t in cuda:
            t.record_stream(self._stream)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        return event

    def save(self, step: int, state: PyTree, *, blocking: bool = False) -> None:
        """The snapshot is taken before this returns; compression and IO
        run on the save thread (or here with ``blocking`` or without
        ``async_save``).  An error there surfaces at the next :meth:`wait`
        or :meth:`save`."""
        self.wait()
        flat = _flatten(state)
        ready = self._after_snapshot(flat)
        is_base = (
            self._save_count % self.cfg.base_every == 0
            or self._last_base_flat is None
            and self._last_base_step is None
        )
        self._save_count += 1
        base_flat = None if is_base else self._last_base_flat
        base_step = None if is_base else self._last_base_step
        if base_flat is None and not is_base:
            is_base = True                      # base lost from memory: full save
        prev_flat = None if is_base else self._last_moment_flat
        prev_step = None if is_base else self._last_save_step

        def work():
            try:
                if ready is not None:
                    with torch.cuda.stream(self._stream):
                        self._stream.wait_event(ready)
                        self._write(step, flat, is_base, base_flat, base_step,
                                    prev_flat, prev_step)
                else:
                    self._write(step, flat, is_base, base_flat, base_step, prev_flat, prev_step)
                if is_base:
                    self._last_base_step = step
                    self._last_base_flat = flat
                if self.cfg.moment_keys:
                    self._last_moment_flat = {
                        k: v for k, v in flat.items()
                        if is_moment_path(k, self.cfg.moment_keys)
                    }
                    self._last_save_step = step
                self._gc()
            except BaseException as e:          # surfaced on the next wait()
                self._errors.append(e)

        if blocking or not self.cfg.async_save:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._errors:
            err = self._errors[:]
            self._errors.clear()
            raise RuntimeError(f"async checkpoint save failed: {err[0]}") from err[0]

    def _write(
        self,
        step: int,
        flat: Flat,
        is_base: bool,
        base_flat: Optional[Flat],
        base_step: Optional[int],
        prev_flat: Optional[Flat] = None,
        prev_step: Optional[int] = None,
    ) -> None:
        cfg, dev = self.cfg.zipnn, self.cfg.device
        tmp = os.path.join(self.cfg.directory, f".tmp_step_{step}")
        final = os.path.join(self.cfg.directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        keys = sorted(flat)
        # Moments delta against the PREVIOUS save; bases still store them
        # in full, which bounds the restore chain at base_every links.
        prev_keys = [
            k for k in keys
            if prev_flat is not None
            and prev_step is not None
            and is_moment_path(k, self.cfg.moment_keys)
            and k in prev_flat
            and _same_shape(prev_flat[k], flat[k])
            and prev_flat[k].dtype == flat[k].dtype
        ]
        prev_set = frozenset(prev_keys)
        # Each kind of delta goes through ONE batched call: on the card,
        # same-dtype (new, base) pairs share one K3 launch with the XOR
        # fused in.  Blobs equal the leaf-at-a-time path's on every backend.
        delta_keys = [
            k for k in keys
            if not is_base
            and k not in prev_set
            and k in base_flat
            and _same_shape(base_flat[k], flat[k])
        ]
        delta_cts = dict(zip(delta_keys, zipnn.delta_compress_batched(
            [flat[k] for k in delta_keys], [base_flat[k] for k in delta_keys], cfg, device=dev,
        )))
        moment_cts = dict(zip(prev_keys, zipnn.delta_compress_batched(
            [flat[k] for k in prev_keys], [prev_flat[k] for k in prev_keys], cfg, device=dev,
        )))
        entries = []
        offset = 0
        with open(os.path.join(tmp, "data.bin"), "wb") as f:
            for key in keys:
                arr = flat[key]
                if key in moment_cts:
                    ct, kind = moment_cts[key], "delta_prev"
                elif key in delta_cts:
                    ct, kind = delta_cts[key], "delta"
                else:
                    ct, kind = zipnn.compress_array(arr, cfg, device=dev), "full"
                f.write(ct.blob)
                entries.append(
                    {
                        "key": key,
                        "kind": kind,
                        "dtype": ct.dtype,
                        "shape": list(ct.shape),
                        "offset": offset,
                        "size": len(ct.blob),
                        "crc": zlib.crc32(ct.blob),
                        "raw": arr.numel() * arr.element_size(),
                    }
                )
                offset += len(ct.blob)
            f.flush()
            os.fsync(f.fileno())
        manifest = {
            "step": step,
            "kind": "base" if is_base else "delta",
            "base_step": base_step,
            "prev_step": prev_step if prev_keys else None,
            "comp_bytes": offset,
            "raw_bytes": sum(e["raw"] for e in entries),
            "entries": entries,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)                  # atomic publish

    def held_bytes(self) -> Dict[str, int]:
        """Bytes the manager holds between saves for the next delta: the
        last base and the previous save's moments, on card and on host."""
        out = {"base_card": 0, "base_host": 0, "moments_card": 0, "moments_host": 0}
        for name, flat in (("base", self._last_base_flat), ("moments", self._last_moment_flat)):
            for t in (flat or {}).values():
                out[f"{name}_{'card' if t.is_cuda else 'host'}"] += t.numel() * t.element_size()
        return out

    # --------------------------------------------------------------- restore

    def _scan(self) -> List[Tuple[int, str, Optional[int]]]:
        out = []
        for name in sorted(os.listdir(self.cfg.directory)):
            if not name.startswith("step_"):
                continue
            mpath = os.path.join(self.cfg.directory, name, "manifest.json")
            try:
                with open(mpath) as f:
                    m = json.load(f)
                out.append((m["step"], m["kind"], m.get("base_step")))
            except (OSError, json.JSONDecodeError):
                continue                        # torn checkpoint: skip
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self._scan()
        return steps[-1][0] if steps else None

    def _load_flat(
        self,
        step: int,
        device_resident: bool = False,
        _cache: Optional[Dict[int, Flat]] = None,
    ) -> Flat:
        # Memoised per restore: a delta save references its base (weights)
        # and the previous save (moments), which references the base again.
        if _cache is None:
            _cache = {}
        if step in _cache:
            return _cache[step]
        cfg, dev = self.cfg.zipnn, self.cfg.device
        d = os.path.join(self.cfg.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(d, "data.bin"), "rb") as f:
            data = f.read()
        # Bases ride the restore's residence: a device_resident restore XORs
        # against card-resident bases (in K2), never bouncing through the host.
        base_flat = None
        if manifest["kind"] == "delta":
            base_flat = self._load_flat(manifest["base_step"], device_resident, _cache)
        prev_flat = None
        if manifest.get("prev_step") is not None:
            prev_flat = self._load_flat(manifest["prev_step"], device_resident, _cache)
        out: Flat = {}
        full_entries = []
        full_cts = []
        for e in manifest["entries"]:
            blob = data[e["offset"] : e["offset"] + e["size"]]
            if zlib.crc32(blob) != e["crc"]:
                raise IOError(f"CRC mismatch in step_{step}:{e['key']}")
            ct = zipnn.CompressedTensor(blob, e["dtype"], tuple(e["shape"]))
            if e["kind"] in ("delta", "delta_prev"):
                against = base_flat if e["kind"] == "delta" else prev_flat
                out[e["key"]] = zipnn.delta_decompress(
                    ct, against[e["key"]], cfg, device_resident=device_resident, device=dev
                )
            else:
                full_entries.append(e)
                full_cts.append(ct)
        if full_cts:
            # One batched decompress_pytree: same-layout leaves share K2
            # launches, and device_resident leaves stay on the card.
            arrays = zipnn.decompress_pytree(
                {"treedef": _util.tree_flatten([0] * len(full_cts))[1], "leaves": full_cts},
                cfg, device_resident=device_resident, device=dev,
            )
            for e, arr in zip(full_entries, arrays):
                out[e["key"]] = arr
        _cache[step] = out
        return out

    def restore(
        self, step: Optional[int] = None, *, device_resident: bool = False
    ) -> Tuple[int, PyTree]:
        """Newest valid checkpoint ≤ ``step`` (or overall): torn or corrupt
        saves are skipped.  Returns a nested dict of CPU tensors, or of
        tensors on the config's ``device`` with ``device_resident``."""
        candidates = [s for s, _, _ in self._scan() if step is None or s <= step]
        for s in reversed(candidates):
            try:
                return s, _unflatten(self._load_flat(s, device_resident=device_resident))
            except (IOError, OSError, KeyError):
                continue
        raise FileNotFoundError(f"no valid checkpoint in {self.cfg.directory}")

    def shard_restore(self, step: Optional[int], mesh, specs: PyTree) -> Tuple[int, PyTree]:
        """:meth:`restore` with ``device_resident=True``, then each leaf laid
        out on ``mesh`` (a ``DeviceMesh``) per its spec in ``specs`` (a
        prefix tree of ``sharding.PartitionSpec``; ``None`` leaves a leaf
        as restored): an elastic rescale, since the saved layout never
        constrains the restored one.  On the card the restore's decode (K1's
        one-shot decode, K2) leaves the leaves there and the layout is made
        device to device."""
        s, tree = self.restore(step, device_resident=True)
        return s, sharding.device_put_tree(tree, mesh, specs)

    # ------------------------------------------------------------- retention

    def _gc(self) -> None:
        saves = self._scan()
        bases = [s for s, k, _ in saves if k == "base"]
        if len(bases) <= self.cfg.keep_bases:
            return
        cutoff = bases[-self.cfg.keep_bases]
        for s, kind, base in saves:
            if s < cutoff:
                path = os.path.join(self.cfg.directory, f"step_{s}")
                for root, _, files in os.walk(path, topdown=False):
                    for fn in files:
                        os.unlink(os.path.join(root, fn))
                    os.rmdir(root)

    # --------------------------------------------------------------- metrics

    def stats(self) -> List[Dict[str, Any]]:
        out = []
        for s, kind, base in self._scan():
            with open(os.path.join(self.cfg.directory, f"step_{s}", "manifest.json")) as f:
                m = json.load(f)
            out.append(
                {
                    "step": s,
                    "kind": kind,
                    "base_step": base,
                    "ratio_pct": 100.0 * m["comp_bytes"] / max(m["raw_bytes"], 1),
                }
            )
        return out
