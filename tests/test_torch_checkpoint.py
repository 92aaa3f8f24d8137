"""The port's checkpoint manager against the reference's, byte for byte.

A checkpoint step is ``manifest.json`` plus ``data.bin``: per-tensor ZNN1
blobs, full at a base, XOR deltas against the base between bases, and
optimizer moments as deltas against the previous save (``delta_prev``).
Contract under test, with exact equality as the tolerance: the same state
(a bf16 ``params`` tree with a list-valued subtree, fp32 AdamW moments
``m``/``v`` and a 0-d step) saved by both managers at ``base_every=3``
over 4 saves (base, delta, delta, base), with and without ``async_save``
and on the device backend (``device="cpu"``: the kernels' plain
versions), gives the same two files at every step; each package restores
the other's directory bit for bit; the flat keys equal
``jax.tree_util.tree_flatten_with_path``'s; torn and corrupt saves are
skipped; retention keeps ``keep_bases``; an async error surfaces at
``wait()``; and the state mutated in place after ``save()`` does not
change what was written.
"""

import json
import os
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_manager
from repro.core import zipnn as ref_zipnn
from repro.optim.adamw import is_moment_path as ref_is_moment_path
from repro_torch import _util
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
from repro_torch.core import zipnn
from repro_torch.core.options import CodecOptions
from repro_torch.optim import is_moment_path

CFG = dict(chunk_param_bytes=1 << 12, backend="huffman")
SHAPES = {"embed": (40, 64), "w": (3, 24, 32)}


def _state(step: int) -> dict:
    """numpy state after ``step`` simulated AdamW steps (seeded): bf16
    params, fp32 moments from EMAs of seeded gradients, a 0-d step."""
    base = {k: np.random.default_rng(i).standard_normal(s) * 0.02
            for i, (k, s) in enumerate(sorted(SHAPES.items()))}
    params = {k: v.copy() for k, v in base.items()}
    m = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    v = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    for t in range(step):
        g = np.random.default_rng(100 + t)
        for k in sorted(SHAPES):
            grad = g.standard_normal(SHAPES[k]).astype(np.float32) * 1e-2
            m[k] = (0.9 * m[k] + 0.1 * grad).astype(np.float32)
            v[k] = (0.95 * v[k] + 0.05 * grad * grad).astype(np.float32)
            params[k] = params[k] - 1e-4 * g.standard_normal(SHAPES[k])
    bf = {k: p.astype(ml_dtypes.bfloat16) for k, p in params.items()}
    return {
        "params": {"embed": bf["embed"], "layers": [bf["w"][0], bf["w"][1:]]},
        "opt": {"m": m, "v": v, "step": np.asarray(step, np.int32)},
    }


def _to_torch(node):
    if isinstance(node, dict):
        return {k: _to_torch(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_torch(v) for v in node)
    a = np.array(node, copy=True)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


def _flat_bits(tree) -> dict:
    return {k: (_bits(v), tuple(np.shape(v))) for k, v in _util.tree_flatten_with_keys(tree)}


def _ref_mgr(directory, **kw):
    return ref_manager.CheckpointManager(ref_manager.CheckpointConfig(
        str(directory), zipnn=ref_zipnn.ZipNNConfig(**CFG), **kw))


def _port_mgr(directory, **kw):
    return CheckpointManager(CheckpointConfig(
        str(directory), zipnn=zipnn.ZipNNConfig(**CFG), device="cpu", **kw))


def _save_all(mgr, steps, to_torch: bool):
    for s in steps:
        st = _state(s)
        mgr.save(s, _to_torch(st) if to_torch else st)
    mgr.wait()


def _files(directory, step):
    d = os.path.join(directory, f"step_{step}")
    return [open(os.path.join(d, n), "rb").read() for n in ("manifest.json", "data.bin")]


@pytest.mark.parametrize("options", [None, CodecOptions(threads=4, backend="device")],
                         ids=["default", "device"])
@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_bytes_equal_reference(tmp_path, async_save, options):
    ref = _ref_mgr(tmp_path / "ref", base_every=3, async_save=async_save)
    port = _port_mgr(tmp_path / "port", base_every=3, async_save=async_save, options=options)
    _save_all(ref, range(4), to_torch=False)
    _save_all(port, range(4), to_torch=True)
    assert [s["kind"] for s in port.stats()] == ["base", "delta", "delta", "base"]
    assert port.stats() == ref.stats()
    for s in range(4):
        assert _files(tmp_path / "port", s) == _files(tmp_path / "ref", s), s
    kinds = {e["key"]: e["kind"] for e in json.loads(_files(tmp_path / "port", 2)[0])["entries"]}
    assert kinds["opt/m/w"] == "delta_prev" and kinds["params/layers/1"] == "delta"


def test_each_package_restores_the_others_directory(tmp_path):
    _save_all(_ref_mgr(tmp_path / "ref", base_every=3, async_save=False), range(4), False)
    _save_all(_port_mgr(tmp_path / "port", base_every=3, async_save=False), range(4), True)
    for step in (2, 3):
        want = _flat_bits(_state(step))
        s, tree = _port_mgr(tmp_path / "ref", base_every=3).restore(step)
        assert s == step and _flat_bits(tree) == want
        assert tree["opt"]["step"].dtype == torch.int32 and tree["opt"]["step"].shape == ()
        s, tree = _ref_mgr(tmp_path / "port", base_every=3).restore(step)
        assert s == step and _flat_bits(tree) == want


def test_device_resident_restore_on_the_plain_kernels(tmp_path):
    port = _port_mgr(tmp_path, base_every=3, async_save=False,
                     options=CodecOptions(backend="device"))
    _save_all(port, range(3), True)
    s, tree = port.restore(device_resident=True)
    assert s == 2 and _flat_bits(tree) == _flat_bits(_state(2))
    assert port.latest_step() == 2


@pytest.mark.parametrize(
    "tree",
    [
        {"b": 1.5, "a": [3, None, (True, np.zeros((2, 2), np.float32))], "c": None},
        {"x": {"z": np.ones(3, np.int8), "y": []}, "w": (np.float64(2.0),)},
        {10: np.arange(4, dtype=np.int16), 9: {"k": np.uint8(7)}},
    ],
)
def test_flat_keys_match_jax_paths(tree):
    want = ref_manager._flatten(tree)
    got = manager._flatten(tree)
    assert list(got) == list(want)
    for k in want:
        assert str(got[k].dtype).removeprefix("torch.") == want[k].dtype.name, k
        assert tuple(got[k].shape) == want[k].shape and _bits(got[k]) == _bits(want[k]), k


def test_moment_paths_match_reference():
    keys = ["m/a", "v", "opt/m/x", "opt/v/y/z", "params/m/w", "m", "mm/a", "opt/mv/x", ""]
    assert [is_moment_path(k) for k in keys] == [ref_is_moment_path(k) for k in keys]


def test_torn_save_is_skipped(tmp_path):
    port = _port_mgr(tmp_path, base_every=3, async_save=False)
    _save_all(port, range(3), True)
    os.makedirs(tmp_path / "step_7")
    (tmp_path / "step_7" / "manifest.json").write_text('{"step": 7, "ki')   # torn write
    os.makedirs(tmp_path / ".tmp_step_8")                              # never published
    assert port.latest_step() == 2
    s, tree = port.restore()
    assert s == 2 and _flat_bits(tree) == _flat_bits(_state(2))


def test_crc_mismatch_falls_back_to_the_previous_save(tmp_path):
    port = _port_mgr(tmp_path, base_every=2, async_save=False)
    _save_all(port, range(4), True)
    data = tmp_path / "step_3" / "data.bin"
    blob = bytearray(data.read_bytes())
    blob[len(blob) // 2] ^= 0x10
    data.write_bytes(bytes(blob))
    s, tree = port.restore()
    assert s == 2 and _flat_bits(tree) == _flat_bits(_state(2))
    ref_s, _ = _ref_mgr(tmp_path, base_every=2).restore()
    assert ref_s == s


def test_gc_keeps_keep_bases_as_the_reference(tmp_path):
    ref = _ref_mgr(tmp_path / "ref", base_every=2, keep_bases=1, async_save=False)
    port = _port_mgr(tmp_path / "port", base_every=2, keep_bases=1, async_save=False)
    _save_all(ref, range(6), False)
    _save_all(port, range(6), True)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == ["step_4", "step_5"]
    # a new manager resumes the base cadence from disk
    again = _port_mgr(tmp_path / "port", base_every=2, keep_bases=1, async_save=False)
    again.save(6, _to_torch(_state(6)))
    assert again.stats()[-1]["kind"] == "base"


def test_async_error_surfaces_at_wait_and_publishes_nothing(tmp_path, monkeypatch):
    port = _port_mgr(tmp_path, base_every=3, async_save=True)

    def fail(*a, **k):
        raise RuntimeError("encode failed")

    monkeypatch.setattr(zipnn, "compress_array", fail)
    port.save(0, _to_torch(_state(0)))
    with pytest.raises(RuntimeError, match="async checkpoint save failed: encode failed"):
        port.wait()
    assert port.latest_step() is None
    assert not any(n.startswith("step_") for n in os.listdir(tmp_path))
    port.wait()                                           # the error is reported once


def test_state_mutated_after_save_does_not_change_what_is_written(tmp_path, monkeypatch):
    port = _port_mgr(tmp_path, base_every=3, async_save=True)
    go = threading.Event()
    write = CheckpointManager._write

    def held(self, *a, **k):
        assert go.wait(30)
        return write(self, *a, **k)

    monkeypatch.setattr(CheckpointManager, "_write", held)
    state = _to_torch(_state(1))
    want = _flat_bits(state)
    port.save(1, state)
    for _, leaf in _util.tree_flatten_with_keys(state):    # an optimizer step in place
        leaf.reshape(-1).view(torch.uint8).add_(1)
    go.set()
    port.wait()
    s, tree = port.restore()
    assert s == 1 and _flat_bits(tree) == want != _flat_bits(state)


def test_config_folds_options_like_the_reference():
    cfg = CheckpointConfig("x", options=CodecOptions(threads=3, backend="device",
                                                    entropy_backend="host"))
    assert (cfg.zipnn.threads, cfg.zipnn.plane_backend, cfg.zipnn.entropy_backend) == (
        3, "device", "host")
    # an explicit field wins over the bag, and an explicit codec config wins over both
    cfg = CheckpointConfig("x", backend="host", options=CodecOptions(backend="device"))
    assert cfg.zipnn.plane_backend == "host"
    cfg = CheckpointConfig("x", backend="device",
                           zipnn=zipnn.ZipNNConfig(plane_backend="host"))
    assert cfg.zipnn.plane_backend == "host"
    assert CheckpointConfig("x").zipnn.plane_backend == "auto"
