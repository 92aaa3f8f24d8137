"""Device resolution, dtype names and nested-dict trees for the package.

Trees are nested ``dict``/``list``/``tuple`` containers of tensors, the
layout the JAX package keeps its params in.  Dicts flatten in sorted-key
order, as ``jax.tree_util`` flattens them, so leaf indices and manifests
line up with the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

__all__ = [
    "resolve_device",
    "dtype_name",
    "torch_dtype",
    "tree_flatten",
    "tree_flatten_with_keys",
    "tree_unflatten",
    "tree_leaves",
    "tree_map",
]


def resolve_device(device: Any) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.

    Entry points default to ``"cuda"``: without a card they raise unless
    the caller asks for ``"cpu"`` explicitly.  A CUDA device without an
    index gets the current one, so the result compares equal to the
    ``.device`` of the tensors made on it.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"`` (the names the codec's layouts use)."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dt


# A treedef is None for a leaf, or (kind, keys, child treedefs) for a node.
TreeDef = Any


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, len(node), [walk(x) for x in node])
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_flatten_with_keys(tree: Any) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in leaf order, keyed as the reference's
    checkpoints key ``jax.tree_util.tree_flatten_with_path``: dict keys
    (sorted) and list/tuple indices joined with ``/``.  ``None`` is an
    empty node, as in JAX: it has no leaf and no key."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, path + (str(i),))
        else:
            out.append(("/".join(path), node))

    walk(tree, ())
    return out


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, kids = d
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, kids)}
        vals = [build(c) for c in kids]
        return tuple(vals) if kind == "tuple" else vals

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the treedef holds")
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])
