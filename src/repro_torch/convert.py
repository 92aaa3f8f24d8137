"""Params and train states exported as numpy arrays → the package's
tensors, bit for bit.

The reference keeps params as nested dicts of arrays; ``numpy.asarray``
of each leaf gives numpy arrays, bf16 ones with a ``bfloat16`` dtype
name from an extension type.  :func:`params_from_numpy` maps each leaf by
its dtype *name* (never importing that extension) and moves 2-byte
floats through an int16 view, so every bit survives.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import _util

__all__ = ["params_from_numpy", "train_state_from_numpy"]


def _leaf(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    name = a.dtype.name
    dt = _util.torch_dtype(name)
    try:
        t = torch.from_numpy(a.copy())           # numpy's own dtypes
    except TypeError:                            # extension dtypes (bf16, fp8)
        ints = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize]
        t = torch.from_numpy(a.view(ints).copy()).view(dt)
    if t.dtype != dt:
        raise ValueError(f"params_from_numpy: {name} leaf became {t.dtype}")
    return t.to(dev)


def params_from_numpy(tree: Any, device: Any = "cuda") -> Any:
    """Nested dicts of numpy arrays → the same tree of tensors on ``device``."""
    dev = _util.resolve_device(device)
    return _util.tree_map(lambda a: _leaf(a, dev), tree)


def train_state_from_numpy(tree: Any, device: Any = "cuda") -> Any:
    """A train state ``{"params", "opt": {"m", "v"}, "step"}`` of numpy
    arrays (the reference's ``init_train_state`` through ``numpy.asarray``)
    → the same state on ``device``: params as :func:`params_from_numpy`
    makes them, f32 moments, a 0-d int32 step."""
    dev = _util.resolve_device(device)
    opt = {k: _util.tree_map(lambda a: _leaf(np.asarray(a, np.float32), dev), tree["opt"][k])
           for k in ("m", "v")}
    return {"params": params_from_numpy(tree["params"], dev), "opt": opt,
            "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=dev)}
