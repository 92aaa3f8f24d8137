"""Multi-pod dry-run: trace every (architecture × shape × mesh) cell on a
fake ``DeviceMesh`` and read each rank's roofline terms off the trace.  A
port of ``repro.launch.dryrun``.

The reference lowers and compiles each step for 512 placeholder devices
and reads XLA's memory and cost analyses.  PyTorch has no compiled
artifact to read, so the port runs the step itself, on DTensors laid out
by the sharding rule table (``distributed/sharding.py``) over a ``fake``
process group of the mesh's world size, every tensor a ``FakeTensor``:
nothing is allocated and no byte moves, but every rank-local op and every
collective that rank 0 would run is dispatched, with its real shapes.

Per cell it records, to ``<out>/<arch>.<shape>.<mesh>.json``:

* ``per_device_memory``: ``argument_bytes`` is the sum of rank 0's local
  shards of the step's inputs, exactly; ``temp_bytes`` is the peak of the
  bytes that the step's local ops allocated and that were still alive
  (activations, the ones autograd saves, gradients, the optimizer's
  temporaries), less the outputs', which ``output_bytes`` counts;
  ``alias_bytes`` is the outputs that are inputs updated in place (the
  train step's params and moments; the reference's donation).
  ``peak_hint_bytes = argument + output + temp - alias``, as the
  reference's, and ``fits`` compares it with :data:`H100_MEMORY_BYTES`.
* ``per_device_accounting``: FLOPs, bytes accessed and collective wire
  bytes of one rank, extrapolated in depth from small depths exactly as
  the reference's ``accounting_costs`` (layers are homogeneous); on the
  single-pod mesh only, as the reference's.
* ``per_device_production_raw``: the same terms of the production step
  (the config's own attention) at full depth, on both meshes.
* ``model_flops`` (``6·N_active·D`` train, ``2·N_active·D`` otherwise),
  ``params`` and ``active_params``.

How each rank-local term is counted (:class:`LocalCounter`, a dispatch
mode that lets DTensor run first and so sees the local ops and the
functional collectives it desugars into; the global op DTensor's sharding
propagation runs on fake tensors to infer shapes is not counted):

* **FLOPs** by ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, attention ops; elementwise ops count 0, as there);
* **bytes accessed**: for every local op that is not a view or a
  collective, the bytes of each tensor it reads plus each tensor it
  writes (views, metadata ops and allocations without a write count 0);
* **collective bytes** from each collective's local result under the
  reference's wire convention (``collective_bytes``): all-gather ×1,
  all-reduce ×2, reduce-scatter ×(group − 1), all-to-all ×1, permute ×1.

Usage::

  python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --device-type cpu

``--device-type`` (default ``cuda``) names the mesh's device type; without
a card (the tests) pass ``cpu``.  FLOPs and bytes do not depend on it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import threading
import time
import traceback
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from ..configs import SHAPES, get_config, list_archs, shape_cells
from ..data.pipeline import DataConfig, batch_specs
from ..distributed.sharding import P, device_put_tree, is_dtensor, mesh_axes_and_sizes, use_mesh
from ..launch.mesh import MULTI_POD, SINGLE_POD, make_production_mesh, n_chips
from ..models import model as model_mod
from ..optim.adamw import AdamWConfig
from ..serve.step import decode_state_specs, inference_param_specs, make_prefill, make_serve_step
from ..train.step import batch_pspecs, make_train_step, train_state_specs

__all__ = [
    "H100_MEMORY_BYTES",
    "COLLECTIVES",
    "TensorSpec",
    "LocalCounter",
    "fake_world",
    "collective_bytes",
    "input_specs",
    "cell_specs",
    "cell_pspecs",
    "dispatch_shards",
    "trace_costs",
    "accounting_costs",
    "run_cell",
    "main",
]

# ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
# 80GB HBM3 (700 W), as ``chip_smoke.py`` prints it: the per-device budget
# a cell's peak must fit.
H100_MEMORY_BYTES = 85_017_493_504

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collective (and DTensor's all-to-all) → the reference's opcode
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")


class TensorSpec(tuple):
    """``(shape, dtype)`` of one input leaf: the reference's
    ``ShapeDtypeStruct``."""

    def __new__(cls, shape, dtype):
        return super().__new__(cls, (tuple(int(s) for s in shape), dtype))

    @property
    def shape(self) -> Tuple[int, ...]:
        return self[0]

    @property
    def dtype(self) -> torch.dtype:
        return self[1]



def collective_bytes(records: List[Tuple[str, int, int]]) -> Dict[str, int]:
    """Per-device collective wire bytes of ``(opcode, local result bytes,
    group size)`` records, under the reference's convention (ring
    schedules): all-gather → result, all-reduce → 2 × result,
    reduce-scatter → result × (group − 1), all-to-all → result,
    collective-permute → result.  Keys: the five opcodes and ``count``."""
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = 0
    for op, rbytes, gs in records:
        if op == "all-reduce":
            wire = 2 * rbytes
        elif op == "reduce-scatter":
            wire = rbytes * max(gs - 1, 1)
        else:
            wire = rbytes
        out[op] += wire
        out["count"] += 1
    return out


# ---------------------------------------------------------------------------
# The rank-local counter
# ---------------------------------------------------------------------------

_prop = threading.local()


@contextlib.contextmanager
def _tracing_patches():
    """Two patches of DTensor's internals for the trace, undone on exit:

    * mark the global op its sharding propagation runs on fake tensors to
      infer an output's shape, so the counter skips it;
    * let a shard-to-shard move over one mesh axis be the all-to-all it
      is on the card also on a ``cpu`` mesh (where DTensor would gather
      the whole and cut it, as gloo has no all-to-all), so a CPU trace
      counts the card's collectives;
    * compute a strided shard's local size and offsets (a few indices of
      a dimension) on real tensors: under ``FakeTensorMode`` DTensor
      would make them fake and fail on reading them;
    * remember the cost DTensor estimates for each redistribution between
      two layouts (a pure function of them, which it recomputes for every
      candidate strategy of every op: most of a trace's time on the
      three-axis mesh)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _collective_utils, _utils, placement_types
    from torch.distributed.tensor._ops import utils as ops_utils
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached
    orig_a2a = placement_types.shard_dim_alltoall
    strided = placement_types._StridedShard
    orig_strided = strided.local_shard_size_and_offset

    def uncounted(fn, *, real=False):
        def run(*args, **kwargs):
            depth = getattr(_prop, "depth", 0)
            _prop.depth = depth + 1
            try:
                if real:
                    with unset_fake_temporarily():
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                _prop.depth = depth

        return run

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        from torch.distributed import _functional_collectives as funcol

        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    orig_cost = ops_utils.redistribute_cost
    costs: Dict[Any, float] = {}

    def cost(current, target):
        key = (current, target)
        if key not in costs:
            costs[key] = uncounted(orig_cost)(current, target)
        return costs[key]

    ShardingPropagator._propagate_tensor_meta_non_cached = uncounted(orig)
    placement_types.shard_dim_alltoall = alltoall
    strided.local_shard_size_and_offset = uncounted(orig_strided, real=True)
    ops_utils.redistribute_cost = _utils.redistribute_cost = cost
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig
        placement_types.shard_dim_alltoall = orig_a2a
        strided.local_shard_size_and_offset = orig_strided
        ops_utils.redistribute_cost = _utils.redistribute_cost = orig_cost
        assert _collective_utils.shard_dim_alltoall is orig_a2a


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _writes_inplace(func) -> bool:
    return any(r.alias_info is not None and r.alias_info.is_write for r in func._schema.returns)


# ops that read and write no element: allocations, metadata
_NO_DATA = frozenset(("empty", "empty_strided", "empty_like", "new_empty",
                      "new_empty_strided", "lift_fresh", "device", "wait_tensor", "detach"))


class LocalCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts what one rank runs: the FLOPs and bytes of its local ops, its
    collectives' wire bytes, and the peak of the bytes its ops allocate.

    Dispatch modes run before tensor subclasses, so on an op with a
    DTensor among its arguments the mode returns ``NotImplemented``:
    DTensor then redistributes and runs the local op, which comes back
    here on plain (fake) tensors.  Ops run while DTensor's sharding
    propagation infers shapes are global, and skipped.
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: List[Tuple[str, int, int]] = []
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakKeyDictionary()     # storage → bytes counted live

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_prop, "depth", 0):
            return out
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NAMESPACES and name in _COLLECTIVE_OPS:
            op = _COLLECTIVE_OPS[name]
            gs = int(args[2]) if op == "reduce-scatter" else 0
            self.collectives.append((op, sum(_nbytes(t) for t in _tensors(out)), gs))
            for t in _tensors(out):
                self._track(t)
            return out
        pk = func._overloadpacket
        if pk in self._flops:
            self.flops += int(self._flops[pk](*args, **kwargs, out_val=out))
        if _is_view(func):
            return out
        if name not in _NO_DATA:
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        if not _writes_inplace(func):
            for t in _tensors(out):
                self._track(t)
        return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks (this process rank
    0, over an in-memory store), destroyed however the block ends."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  registers "fake"

    if dist.is_initialized():
        raise RuntimeError("a process group is already started; the dry-run starts its own")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _spec_tree(shapes, dtypes):
    if isinstance(shapes, dict):
        return {k: _spec_tree(shapes[k], dtypes[k]) for k in shapes}
    return TensorSpec(shapes, dtypes)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def input_specs(arch: str, shape: str) -> Dict[str, Any]:
    """:class:`TensorSpec` stand-ins for every input of the traced step
    (the reference's ``ShapeDtypeStruct`` tree): ``{"state", "batch"}``
    for train, ``{"params", "batch"}`` for prefill, ``{"params", "dstate",
    "tokens"}`` for decode (one new token against a full cache)."""
    return cell_specs(get_config(arch), SHAPES[shape])


def cell_specs(cfg, cell) -> Dict[str, Any]:
    """:func:`input_specs` of any config (a reduced one) and cell."""
    params = _spec_tree(model_mod.param_shapes(cfg), model_mod.param_dtypes(cfg))
    dc = DataConfig(seq_len=cell.seq_len, global_batch=cell.global_batch)
    batch = {k: TensorSpec(s, d) for k, (s, d) in batch_specs(cfg, dc).items()}
    if cell.kind == "train":
        f32 = _map_specs(lambda s: TensorSpec(s.shape, torch.float32), params)
        state = {"params": params, "opt": {"m": f32, "v": f32},
                 "step": TensorSpec((), torch.int32)}
        return {"state": state, "batch": batch}
    if cell.kind == "prefill":
        return {"params": params, "batch": batch}
    dstate = model_mod.init_decode_state(cfg, cell.global_batch, cell.seq_len, device="meta")
    return {
        "params": params,
        "dstate": _map_specs(lambda t: TensorSpec(t.shape, t.dtype), dstate),
        "tokens": TensorSpec((cell.global_batch, 1), torch.int32),
    }


def cell_pspecs(cfg, cell, specs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The layout of each of :func:`cell_specs`' inputs on ``mesh``: the
    train state's and batch's (``train.step``), the params' (prefill) or
    the serving layouts (decode: ``serve.step``), the decode tokens by
    batch where it divides the 'data' axis."""
    meta = _map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)
    out: Dict[str, Any] = {}
    if "batch" in meta:
        out["batch"] = batch_pspecs(meta["batch"], mesh)
    if cell.kind == "train":
        out["state"] = train_state_specs(cfg, mesh)
    elif cell.kind == "prefill":
        out["params"] = model_mod.param_specs(cfg, mesh)
    else:
        sizes = mesh_axes_and_sizes(mesh)[1]
        out["params"] = inference_param_specs(cfg, mesh)
        out["dstate"] = decode_state_specs(cfg, meta["dstate"], mesh)
        out["tokens"] = P("data" if cell.global_batch % sizes["data"] == 0 else None, None)
    return out


def dispatch_shards(cfg, cell, mesh) -> int:
    """MoE dispatch locality: one dispatch row per batch shard (the
    reference's ``_with_dispatch_shards``), 1 where the tokens do not split
    evenly over the batch axes, and 1 for every other family."""
    if not cfg.moe:
        return cfg.dispatch_shards
    sizes = mesh_axes_and_sizes(mesh)[1]
    bs = sizes.get("pod", 1) * sizes.get("data", 1)
    t = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    return 1 if t % bs else bs


def _materialise(specs, device: str):
    """Fake tensors (under the caller's ``FakeTensorMode``) for a spec tree."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype, device=device), specs)


_STEP_ARGS = {"train": ("state", "batch"), "prefill": ("params", "batch"),
              "decode": ("params", "dstate", "tokens")}


def _step_inputs(cfg, cell, mesh, device: str):
    """``(step function, its args as DTensors on mesh)`` of one cell."""
    specs = cell_specs(cfg, cell)
    layout = cell_pspecs(cfg, cell, specs, mesh)
    args = tuple(device_put_tree(_materialise(specs[k], device), mesh, layout[k])
                 for k in _STEP_ARGS[cell.kind])
    step = {"train": lambda: make_train_step(cfg, AdamWConfig()),
            "prefill": lambda: make_prefill(cfg),
            "decode": lambda: make_serve_step(cfg)}[cell.kind]()
    return step, args


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor on this rank; any other tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _local_bytes(tree) -> int:
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

def trace_costs(cfg, cell, mesh, device: str = "cuda", *, memory: bool = False) -> Dict[str, Any]:
    """Trace one step of ``cfg`` on ``mesh`` (whose process group the
    caller started) and return rank 0's terms: ``flops``,
    ``bytes_accessed``, ``coll_<opcode>``/``coll_count``, and with
    ``memory`` the ``per_device_memory`` dict."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = dataclasses.replace(cfg, dispatch_shards=dispatch_shards(cfg, cell, mesh))
    with FakeTensorMode(allow_non_fake_inputs=True), use_mesh(mesh), implicit_replication():
        step, args = _step_inputs(cfg, cell, mesh, device)
        arg_bytes = _local_bytes(args)
        arg_storages = {_local(t).untyped_storage()._cdata for t in _tensors(args)}
        counter = LocalCounter()
        with _tracing_patches(), counter:
            out = step(*args)
        out_bytes = _local_bytes(out)
        # outputs that are inputs updated in place (the reference's donation)
        alias = sum(_nbytes(_local(t)) for t in _tensors(out)
                    if _local(t).untyped_storage()._cdata in arg_storages)
        coll = collective_bytes(counter.collectives)
        res: Dict[str, Any] = {"flops": float(counter.flops),
                               "bytes_accessed": float(counter.bytes_accessed)}
        for k, v in coll.items():
            res[f"coll_{k}"] = float(v)
        if memory:
            fresh_out = out_bytes - alias
            temp = max(counter.peak - fresh_out, 0)
            res["memory"] = {
                "argument_bytes": int(arg_bytes),
                "output_bytes": int(out_bytes),
                "temp_bytes": int(temp),
                "alias_bytes": int(alias),
                "peak_hint_bytes": int(arg_bytes + out_bytes + temp - alias),
            }
        del out, args
    return res


def _depth(cfg, n: int, **over):
    return dataclasses.replace(cfg, n_layers=n, **over)


def series_depths(cfg) -> List[int]:
    """The depths the terms extrapolate from (the reference's): 1 and 2;
    2 and 3 for MoE with ``first_k_dense``; ``e``, ``e + 1`` and ``2e`` for
    the hybrid family, whose shared attention runs every ``e`` Mamba2
    layers (6, 7 and 12: a Mamba2 layer and a shared-attention
    application apart)."""
    if cfg.family == "hybrid":
        e = cfg.shared_attn_every
        return [e, e + 1, 2 * e]
    if cfg.moe and cfg.first_k_dense:
        return [2, 3]
    return [1, 2]


def extrapolate(cfg, terms: Dict[int, Dict[str, float]]) -> Dict[str, float]:
    """Each term at ``cfg.n_layers`` from its values at
    :func:`series_depths` (exact where the layers are homogeneous)."""
    d = series_depths(cfg)
    if cfg.family == "hybrid":
        e = cfg.shared_attn_every
        fe, fe1, f2e = (terms[n] for n in d)
        ng = cfg.n_layers // e
        out = {}
        for k in fe:
            m = fe1[k] - fe[k]                      # one Mamba2 layer
            sh = (f2e[k] - fe[k]) - e * m           # one shared-attention application
            out[k] = fe[k] - e * m - sh + cfg.n_layers * m + ng * sh
        return out
    a, b = (terms[n] for n in d)
    return {k: a[k] + (cfg.n_layers - d[0]) * (b[k] - a[k]) for k in a}


def _series(cfg, cell, mesh, device: str, over: Dict[str, Any]) -> Dict[str, float]:
    """The terms extrapolated to the full depth from the traces at
    :func:`series_depths` (``over`` replaces config fields)."""
    return extrapolate(cfg, {n: trace_costs(_depth(cfg, n, **over), cell, mesh, device)
                             for n in series_depths(cfg)})


def accounting_costs(cfg, cell, mesh, device: str = "cuda") -> Dict[str, float]:
    """Per-device terms of the whole depth, extrapolated from small depths
    (:func:`_series`): dense attention for FLOPs and collectives (FLOP-
    identical to the masked flash loop, which skips dead blocks), the
    flash loop for ``bytes_accessed`` (dense materialises the S × S scores
    the flash loop never holds whole; its bytes are kept as
    ``bytes_accessed_dense_ub``), as the reference's."""
    acct = _series(cfg, cell, mesh, device, dict(attn_impl="dense"))
    if cell.kind != "decode" and cfg.family != "ssm":
        flash = _series(cfg, cell, mesh, device, dict(attn_impl="flash"))
        acct["bytes_accessed_dense_ub"] = acct["bytes_accessed"]
        acct["bytes_accessed"] = flash["bytes_accessed"]
    return acct


def model_flops(cfg, cell) -> float:
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        return float(6 * n_active * cell.seq_len * cell.global_batch)
    if cell.kind == "prefill":
        return float(2 * n_active * cell.seq_len * cell.global_batch)
    return float(2 * n_active * cell.global_batch)


def run_cell(
    arch: str, shape: str, *, multi_pod: bool, device_type: str = "cuda",
    out_dir: Optional[str] = None, cfg_override=None,
) -> Dict[str, Any]:
    """Trace one cell on its production mesh, over a ``fake`` process group
    this call starts and destroys before it returns, however it ends.

    The production step (the config's attention) is traced at full depth
    and gives the memory and the raw terms; then, on the single-pod mesh,
    the accounting series (:func:`accounting_costs`)."""
    cfg = cfg_override or get_config(arch)
    cell = SHAPES[shape]
    world = 1
    for s in (MULTI_POD if multi_pod else SINGLE_POD):
        world *= s
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
        chips = n_chips(mesh)
        t0 = time.perf_counter()
        raw = trace_costs(cfg, cell, mesh, device_type, memory=True)
        mem = raw.pop("memory")
        t_trace = time.perf_counter() - t0
        # the accounting terms feed the single-pod roofline, as the
        # reference's; the two-pod pass is the pod axis's shard proof
        # (memory, and the raw terms of its production step)
        t0 = time.perf_counter()
        acct = {} if multi_pod else accounting_costs(cfg, cell, mesh, device_type)
        t_acct = time.perf_counter() - t0

    result: Dict[str, Any] = {
        "arch": arch,
        "shape": shape,
        "kind": cell.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "seq_len": cell.seq_len,
        "global_batch": cell.global_batch,
        "params": int(cfg.param_count()),
        "active_params": int(cfg.active_param_count()),
        "model_flops": model_flops(cfg, cell),
        "device_type": device_type,
        "trace_s": round(t_trace, 1),
        "accounting_s": round(t_acct, 1),
        "per_device_production_raw": {
            "flops": raw["flops"],
            "bytes_accessed": raw["bytes_accessed"],
            "collectives_bytes": {k[5:]: int(v) for k, v in raw.items() if k.startswith("coll_")},
        },
        "per_device_memory": mem,
        "device_memory_bytes": H100_MEMORY_BYTES,
        "fits": mem["peak_hint_bytes"] <= H100_MEMORY_BYTES,
        "per_device_accounting": acct,
        "status": "ok",
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}.{shape}.{result['mesh']}.json")
        with open(fn, "w") as f:
            json.dump(result, f, indent=1)
    return result


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _run_one(job) -> Tuple[str, bool, str]:
    """One cell of the CLI, in this process or a worker: ``(tag, ok,
    line)``; a failure writes the reference's ``"fail"`` record."""
    arch, shape, mp, device_type, out = job
    tag = f"{arch}.{shape}.{_mesh_name(mp)}"
    try:
        r = run_cell(arch, shape, multi_pod=mp, device_type=device_type, out_dir=out)
    except Exception as e:
        if out:
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, f"{tag}.json"), "w") as f:
                json.dump({"arch": arch, "shape": shape, "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}, f)
        return tag, False, (f"[FAIL] {tag}: {type(e).__name__}: {e}\n"
                            + traceback.format_exc(limit=6))
    raw, mem = r["per_device_production_raw"], r["per_device_memory"]
    acct = r["per_device_accounting"] or {
        "flops": raw["flops"], **{f"coll_{k}": v for k, v in raw["collectives_bytes"].items()}}
    coll = sum(v for k, v in acct.items() if k.startswith("coll_") and k != "coll_count")
    return tag, True, (f"[ok]   {tag}: trace={r['trace_s']}s acct={r['accounting_s']}s "
                       f"flops/dev={acct['flops']:.6g} "
                       f"mem/dev={mem['peak_hint_bytes'] / 2**30:.2f}GiB "
                       f"coll/dev={coll / 2**20:.1f}MiB")


def summary_table(out_dir: str) -> str:
    """A Markdown table of the cell JSONs under ``out_dir``: one row an
    (arch, shape), the single-pod mesh's accounting terms and memory, the
    two-pod mesh's raw terms and memory, and each cell's trace seconds."""
    cells: Dict[Tuple[str, str], Dict[str, Dict[str, Any]]] = {}
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                r = json.load(f)
            cells.setdefault((r["arch"], r["shape"]), {})[r.get("mesh", "?")] = r

    def coll(terms):
        return sum(v for k, v in terms.items() if k != "count" and not k.startswith("coll_count"))

    def gib(r):
        """The peak in GiB, marked ``!`` where it does not fit
        :data:`H100_MEMORY_BYTES`."""
        n = r["per_device_memory"]["peak_hint_bytes"]
        return f"{n / 2**30:.3f}" + ("!" if n > H100_MEMORY_BYTES else "")

    rows = ["| arch | shape | 16x16 FLOPs/dev (acct.) | bytes/dev | coll B/dev | peak GiB "
            "| 2x16x16 FLOPs/dev (prod.) | coll B/dev | peak GiB | trace s (16x16 / 2x16x16) |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    order = {a: i for i, a in enumerate(list_archs())}
    for (arch, shape), by_mesh in sorted(cells.items(), key=lambda kv: (order.get(kv[0][0], 99),
                                                                         list(SHAPES).index(kv[0][1]))):
        one, two = by_mesh.get("16x16", {}), by_mesh.get("2x16x16", {})
        if one.get("status") != "ok" or two.get("status") != "ok":
            rows.append(f"| {arch} | {shape} | {one.get('status')} | | | | {two.get('status')} "
                        "| | | |")
            continue
        a = one["per_device_accounting"]
        t = two["per_device_production_raw"]
        rows.append(
            f"| {arch} | {shape} | {a['flops']:.4g} | {a['bytes_accessed']:.4g} "
            f"| {coll({k[5:]: v for k, v in a.items() if k.startswith('coll_')}):.4g} "
            f"| {gib(one)} | {t['flops']:.4g} | {coll(t['collectives_bytes']):.4g} | {gib(two)} "
            f"| {one['trace_s'] + one['accounting_s']:.0f} / {two['trace_s']:.0f} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", type=str, default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="every applicable cell")
    ap.add_argument("--out", type=str, default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device-type", type=str, default="cuda",
                    help="the meshes' device type (cpu without a card)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    ap.add_argument("--summary", action="store_true",
                    help="print the Markdown table of the JSONs under --out and stop")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary_table(args.out))
        return

    if args.all:
        cells = [(a, c.name) for a in list_archs() for c in shape_cells(get_config(a))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    jobs = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}.{shape}.{_mesh_name(mp)}"
            if args.skip_existing and os.path.exists(os.path.join(args.out, f"{tag}.json")):
                print(f"[skip] {tag}")
                continue
            jobs.append((arch, shape, mp, args.device_type, args.out))

    failures = 0
    if args.jobs > 1:
        import multiprocessing as mp_

        with mp_.get_context("spawn").Pool(args.jobs, maxtasksperchild=1) as pool:
            for _, ok, line in pool.imap_unordered(_run_one, jobs):
                failures += not ok
                print(line, flush=True)
    else:
        for job in jobs:
            _, ok, line = _run_one(job)
            failures += not ok
            print(line, flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
