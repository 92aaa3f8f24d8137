"""Logical-axis sharding: one rule table maps logical tensor axes to mesh
axes, and name-pattern rules over the param tree's paths give each param
its spec.  A port of ``repro.distributed.sharding`` onto ``DeviceMesh``
and DTensor placements.

A spec keeps the reference's form: a :class:`PartitionSpec`, one entry a
tensor dimension, each a mesh-axis name, a tuple of names or ``None``.
:func:`placements` turns a spec and a ``DeviceMesh`` into DTensor
placements (``Shard(d)`` / ``Replicate()`` a mesh dimension).

Mesh axes: ('data', 'model') single-pod, ('pod', 'data', 'model') two-pod.
Batch shards over ('pod', 'data'); heads/ff/experts/vocab over 'model';
with ZeRO-3 (``zero3=True`` archs) the non-model parameter axis
additionally shards over 'data'.

The spec functions take a ``DeviceMesh`` (its ``mesh_dim_names`` and
``shape``) or any object with ``axis_names`` and a ``shape`` dict.  The
"current mesh", which the reference reads from JAX's context, is a
thread-local here: :func:`use_mesh` sets it beside :func:`axis_rules`.
:func:`lshard` has no numeric effect and the port's model does not call
it, so the forward is bit-identical with or without a mesh.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "DEFAULT_RULES",
    "PartitionSpec",
    "P",
    "axis_rules",
    "active_rules",
    "use_mesh",
    "current_mesh",
    "resolve",
    "axis_size",
    "lshard",
    "placements",
    "param_pspecs",
    "device_put_tree",
    "batch_pspec",
]

_state = threading.local()


def _canonical(entry: Any) -> Any:
    """An entry as ``jax.sharding.PartitionSpec`` keeps it: a tuple of one
    name is that name, an empty tuple is ``None``."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry or None
    return entry


class PartitionSpec(tuple):
    """Per tensor dimension: a mesh-axis name, a tuple of names, or
    ``None`` (replicated).  ``PartitionSpec(None, "model")``.  Entries are
    canonical as the reference's: ``P(("data",))`` is ``P("data")``."""

    def __new__(cls, *axes: Any) -> "PartitionSpec":
        return super().__new__(cls, (_canonical(a) for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),   # filtered to existing mesh axes at use
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "experts_serve": "data",    # inference EP: experts live on the data axis
    "zero3": "data",            # secondary param axis under ZeRO-3
    "seq_sp": "model",          # sequence-parallel residual carry (cfg.sp)
}


def mesh_axes_and_sizes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """``(axis names, {name: size})`` of a ``DeviceMesh`` or of an object
    with ``axis_names`` and a ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), dict(zip(names, mesh.shape))
    return tuple(mesh.axis_names), dict(mesh.shape)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, Any]):
    """Activate logical→mesh rules (launcher scope)."""
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def active_rules() -> Optional[Dict[str, Any]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh of this thread (what JAX's mesh
    context is to the reference): :func:`lshard`, :func:`axis_size` and the
    spec functions called without a mesh read it."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def current_mesh():
    return getattr(_state, "mesh", None)


def _current_mesh_axes() -> Optional[Tuple[str, ...]]:
    mesh = current_mesh()
    return None if mesh is None else mesh_axes_and_sizes(mesh)[0]


def resolve(logical: Optional[str], mesh_axes: Tuple[str, ...]) -> Any:
    rules = active_rules() or DEFAULT_RULES
    target = rules.get(logical) if logical else None
    if target is None:
        return None
    if isinstance(target, tuple):
        hit = tuple(a for a in target if a in mesh_axes)
        return hit if hit else None
    return target if target in mesh_axes else None


def axis_size(name: str) -> int:
    """Size of a mesh axis in the current mesh (1 if absent)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return mesh_axes_and_sizes(mesh)[1].get(name, 1)


def placements(spec: Tuple[Any, ...], mesh) -> List[Any]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dimension that tensor dimension ``d`` names, ``Replicate()`` on the
    others.  A dimension sharded over a tuple of mesh axes lists those mesh
    dimensions in the tuple's order, which must be the mesh's order (the
    order DTensor shards in)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes_and_sizes(mesh)[0])
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: mesh axes {axes} are not in the mesh's order {names}")
        for m in dims:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[m]!r} shards two dimensions")
            out[m] = Shard(d)
    return out


def lshard(x, *logical_axes: Optional[str]):
    """Lay a DTensor out by logical axis names on the current mesh; ``x``
    itself without a mesh, and a plain tensor passes through."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    mesh_axes = mesh_axes_and_sizes(mesh)[0]
    spec = P(*[resolve(a, mesh_axes) for a in logical_axes])
    return x.redistribute(mesh, placements(spec, mesh))


# ---------------------------------------------------------------------------
# Parameter spec rules (name-pattern over tree paths)
# ---------------------------------------------------------------------------

# (regex over '/'-joined path, logical axes per trailing dimension).
# Leading scan (layer-stack) axes are padded with None automatically.
# ORDER MATTERS: first match wins — expert rules must precede the generic
# MLP rules (expert paths end in the same leaf names).
_PARAM_RULES = [
    # experts dominate MoE parameter/optimizer bytes → ZeRO-3 shards their
    # d_model dim over 'data' on top of expert parallelism over 'model'
    (r"experts/(w_gate|w_up)$", (("experts",), ("zero3",), None)),
    (r"experts/w_down$", (("experts",), None, ("zero3",))),
    (r"(wq|wk|wv|w_uq|w_uk|w_uv)/w$", (("zero3",), ("heads",))),
    (r"(wq|wk|wv)/b$", (("heads",),)),
    (r"wo/w$", (("heads",), ("zero3",))),
    # SwiGLU/GELU MLP leaves are raw arrays (no trailing '/w')
    (r"(w_gate|w_up|w_in)$", (("zero3",), ("ff",))),
    (r"(w_down|w_out)$", (("ff",), ("zero3",))),
    (r"b_in$", (("ff",),)),
    (r"(embed|lm_head|cls_head)/table$", (("vocab",), ("zero3",))),
    (r"pos/table$", (None, ("ff",))),
    (r"frontend_proj/w$", (None, ("zero3",))),
    (r"router/w$", (None, None)),
    (r"(w_dq|w_dkv|w_kr)/w$", (("zero3",), None)),
    # SSM params
    (r"(in_proj|out_proj)/w$", (("zero3",), ("heads",))),
    (r"ssm/(A_log|D|dt_bias)$", (("heads",),)),
    (r"conv/w$", (None, ("heads",))),
]


def _axis_size(axis: Any, mesh_sizes: Dict[str, int]) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh_sizes.get(a, 1)
        return n
    return mesh_sizes.get(axis, 1)


def _spec_for(
    path: str,
    shape: Tuple[int, ...],
    zero3: bool,
    mesh_axes: Tuple[str, ...],
    mesh_sizes: Dict[str, int],
) -> PartitionSpec:
    ndim = len(shape)
    for pat, dims in _PARAM_RULES:
        if re.search(pat, path):
            axes = []
            for d in dims:
                if d is None:
                    axes.append(None)
                    continue
                logical = d[0] if isinstance(d, tuple) else d
                if logical == "zero3":
                    axes.append(resolve("zero3", mesh_axes) if zero3 else None)
                elif logical == "ff_inner":
                    # expert-parallel models shard E over 'model'; the inner
                    # ff dim stays unsharded to avoid double-cutting
                    axes.append(None)
                else:
                    axes.append(resolve(logical, mesh_axes))
            pad = ndim - len(axes)               # leading scan axes
            axes = [None] * pad + axes
            # divisibility guard: unshardable dims (odd vocab, few kv heads)
            # fall back to replicated on that dim
            axes = [
                a if shape[i] % _axis_size(a, mesh_sizes) == 0 else None
                for i, a in enumerate(axes)
            ]
            return P(*axes)
    return P(*([None] * ndim))   # norms, scalars, biases: replicated


def _is_shape(node: Any) -> bool:
    """A shape leaf of a tree of shapes (``models.model.param_shapes``):
    a tuple of ints."""
    return isinstance(node, tuple) and all(isinstance(n, int) for n in node)


def map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn('/'-joined path, leaf)`` over every leaf of a tree of dicts and
    lists whose leaves are tensors (anything with a ``shape``), shapes or
    specs, keyed as the reference's ``tree_map_with_path`` keys its
    paths."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not (_is_shape(tree)
                                                or isinstance(tree, PartitionSpec)):
        return type(tree)(map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _leaf_shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(leaf) if _is_shape(leaf) else tuple(leaf.shape)


def param_pspecs(params: Any, *, zero3: bool = False, mesh=None) -> Any:
    """Spec tree matching ``params`` (tensors or shapes) via the name
    rules.  Without ``mesh`` the current mesh's axes resolve, every axis
    counting as size 1."""
    if mesh is not None:
        mesh_axes, mesh_sizes = mesh_axes_and_sizes(mesh)
    else:
        mesh_axes, mesh_sizes = _current_mesh_axes() or (), {}
    return map_with_path(
        lambda path, leaf: _spec_for(path, _leaf_shape(leaf), zero3, mesh_axes, mesh_sizes),
        params)


def device_put_tree(tree: Any, mesh, specs: Any) -> Any:
    """Lay every leaf of ``tree`` out on ``mesh`` per its spec.

    ``specs`` is a prefix tree of :class:`PartitionSpec`\\ s; ``None``
    leaves the leaf (or subtree) as it is.  Each other leaf becomes
    ``distribute_tensor(leaf, mesh, placements(spec, mesh))``.  Every rank
    holds the whole tree (as every process passes the whole value to the
    reference's ``jax.device_put``), so each keeps its own shard and
    nothing is sent between ranks (``src_data_rank=None``); a leaf already
    on the mesh's device type is cut there, device to device, so a
    card-resident restore sends nothing back to the host.  This is the
    back half of ``CheckpointManager.shard_restore``: the saved layout
    never constrains the restored one.
    """
    from torch.distributed.tensor import distribute_tensor

    if specs is None:
        return tree
    if isinstance(specs, PartitionSpec):
        return distribute_tensor(tree, mesh, placements(specs, mesh), src_data_rank=None)
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(specs) != set(tree):
            raise ValueError(f"specs {sorted(specs)} are not a prefix of the tree")
        return {k: device_put_tree(v, mesh, specs[k]) for k, v in tree.items()}
    if (isinstance(specs, (list, tuple)) and isinstance(tree, (list, tuple))
            and len(specs) == len(tree)):
        return type(tree)(device_put_tree(v, mesh, s) for v, s in zip(tree, specs))
    raise ValueError(f"specs of type {type(specs).__name__} do not match the tree")


def batch_pspec(mesh=None) -> PartitionSpec:
    mesh_axes = (mesh_axes_and_sizes(mesh)[0] if mesh is not None
                 else _current_mesh_axes() or ())
    return P(resolve("batch", mesh_axes))
