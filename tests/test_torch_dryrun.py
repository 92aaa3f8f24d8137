"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), and on its own.

Against the reference:

* the same 32 (arch, shape) cells from ``shape_cells``;
* ``input_specs``: every leaf's shape and dtype equal the reference's
  ``input_specs`` tree's for every cell (the reference's side built as its
  ``input_specs`` builds it: ``abstract_train_state``, ``abstract_params``,
  ``batch_specs`` and ``jax.eval_shape`` of the decode state);
* ``params``, ``active_params`` and ``model_flops`` equal the reference's
  (its configs' counts, its ``run_cell`` formula) for every cell;
* ``collective_bytes`` of the four collectives of the reference's parser
  test gives the bytes the reference's parser gives for their HLO.

The port alone, over ``fake`` process groups (``--device-type cpu``):

* two matmuls on the 16x16 mesh count their per-device FLOPs, not the
  global op's: 536,870,912;
* a one-token product on a mesh folds into one 2-D product (no weight
  expanded a row);
* the live-bytes tracker's peak on plain fake tensors;
* each family's reduced config traced at a third depth equals the depth
  series' extrapolation, term for term (in a prefill, the peak of live
  bytes is no sum over layers and is left out);
* one cell of each family kind (reduced widths, the cell's full shape)
  reads ``status`` ``"ok"`` with ``argument_bytes`` equal to the local
  shards' bytes computed from the specs alone; the CLI writes the
  reference's keys;
* no process group outlives the file.

The reference's dry-run module sets ``XLA_FLAGS`` for 512 host devices
when imported; the import here restores the variable at once, so a later
test file in the same worker keeps one device.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.configs import shape_cells as ref_shape_cells
from repro.data import DataConfig as RefDataConfig
from repro.data import batch_specs as ref_batch_specs
from repro.models import build_model
from repro.train.step import abstract_train_state
from repro_torch.configs import SHAPES, get_config, list_archs, shape_cells
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun

CELLS = [(a, c.name) for a in list_archs() for c in shape_cells(get_config(a))]


def _reference_dryrun():
    """``repro.launch.dryrun`` with ``XLA_FLAGS`` as it was before."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

def test_same_cells_as_the_reference():
    ref = [(a, c.name) for a in ref_list_archs() for c in ref_shape_cells(ref_get_config(a))]
    assert CELLS == ref
    assert len(CELLS) == 32


_REF_PARAMS = {}


def _ref_input_specs(arch, shape):
    """The reference's ``input_specs`` tree, built as it builds it."""
    cfg = ref_get_config(arch)
    cell = REF_SHAPES[shape]
    model = build_model(cfg)
    dc = RefDataConfig(seq_len=cell.seq_len, global_batch=cell.global_batch)
    if cell.kind == "train":
        return {"state": abstract_train_state(model), "batch": ref_batch_specs(cfg, dc)}
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = model.abstract_params()
    if cell.kind == "prefill":
        return {"params": _REF_PARAMS[arch], "batch": ref_batch_specs(cfg, dc)}
    state = jax.eval_shape(lambda: model.init_decode_state(cell.global_batch, cell.seq_len))
    return {"params": _REF_PARAMS[arch], "dstate": state,
            "tokens": jax.ShapeDtypeStruct((cell.global_batch, 1), jnp.int32)}


def _ref_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (str(k),)))
        return out
    name = str(tree.dtype).replace("torch.", "")
    return {"/".join(path): (tree.shape, name)}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference(arch, shape):
    want = _ref_leaves(_ref_input_specs(arch, shape))
    got = _port_leaves(dryrun.input_specs(arch, shape))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("arch,shape", CELLS)
def test_counts_and_model_flops_equal_reference(arch, shape):
    rcfg, cell = ref_get_config(arch), REF_SHAPES[shape]
    # the reference's run_cell: 6·N_active·tokens train, 2·N_active·tokens else
    n_active = rcfg.active_param_count()
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    want = float((6 if cell.kind == "train" else 2) * n_active * tokens)
    cfg = get_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == n_active
    assert dryrun.model_flops(cfg, SHAPES[shape]) == want


def test_collective_bytes_equal_reference_parser():
    hlo = """
  %all-reduce.1 = f32[128,64]{1,0} all-reduce(%x), channel_id=1, replica_groups=[16,16]<=[256], use_global_device_ids=true, to_apply=%add
  %ag = bf16[2048,512]{1,0} all-gather(%p), channel_id=2, replica_groups=[16,16]<=[256], dimensions={0}
  %rs = f32[16,8]{1,0} reduce-scatter(%y), channel_id=3, replica_groups=[4,4]<=[16], to_apply=%add
  %cp = u8[1000]{0} collective-permute(%z), channel_id=4, source_target_pairs={{0,1}}
"""
    want = _reference_dryrun().collective_bytes(hlo)
    got = dryrun.collective_bytes([
        ("all-reduce", 128 * 64 * 4, 16), ("all-gather", 2048 * 512 * 2, 16),
        ("reduce-scatter", 16 * 8 * 4, 4), ("collective-permute", 1000, 2)])
    assert got == want
    assert got["reduce-scatter"] == 16 * 8 * 4 * 3 and got["count"] == 4


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh16():
    """The 16x16 ``("data", "model")`` cpu mesh over a fake group of 256."""
    from repro_torch.launch.mesh import make_production_mesh

    with dryrun.fake_world(256):
        yield make_production_mesh(device_type="cpu")


def test_matmul_flops_are_per_device(mesh16):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with FakeTensorMode():
        x = distribute_tensor(torch.empty(1024, 4096), mesh16, [Shard(0), Replicate()])
        w1 = distribute_tensor(torch.empty(4096, 8192), mesh16, [Replicate(), Shard(1)])
        w2 = distribute_tensor(torch.empty(8192, 4096), mesh16, [Replicate(), Shard(0)])
        counter = dryrun.LocalCounter()
        with dryrun._tracing_patches(), counter:
            (x @ w1) @ w2
    assert counter.flops == 536_870_912             # 137,438,953,472 / 256
    assert 2 * 1024 * 4096 * 8192 * 2 == 256 * counter.flops
    # the second product's partial sums are not reduced: no collective yet
    assert counter.collectives == []


def test_a_one_token_product_folds(mesh16):
    """``from_local`` scales a size-1 dimension's stride by the shard
    count, and ``matmul`` of such a (B, 1, D) input then expands the weight
    B times; ``product_input`` gives the input contiguous strides, so the
    product is one (B, D) @ (D, V) on each rank."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.distributed.sharding import product_input

    with FakeTensorMode():
        w = distribute_tensor(torch.empty(64, 512), mesh16, [Replicate(), Replicate()])
        x = DTensor.from_local(torch.empty(4, 1, 64), mesh16, [Shard(0), Replicate()],
                               run_check=False)
        assert x.stride() == (64, 1024, 1)                  # the scaled stride
        peaks = []
        for inp in (x, product_input(x)):
            counter = dryrun.LocalCounter()
            with dryrun._tracing_patches(), counter:
                y = inp @ w
            peaks.append(counter.peak)
            del y
    assert product_input(x).stride() == (64, 64, 1)
    assert peaks[1] == 4 * 512 * 4                          # the (4, 1, 512) f32 output
    assert peaks[0] >= 4 * 64 * 512 * 4                     # the weight expanded 4 times


def test_live_bytes_peak():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a = torch.empty(1000)
        counter = dryrun.LocalCounter()
        with counter:
            b = a * 2                 # 4,000 bytes
            c = b + 1                 # 8,000 live
            del b                     # 4,000 live
            d = c.view(-1)            # a view allocates nothing
            e = torch.cat([c, d])     # 4,000 + 8,000 = 12,000 live
            del c, d, e
    assert counter.peak == 12_000
    assert counter.live == 0


FAMILY_ARCHS = {
    "dense": ("repro_gpt_100m", "train_4k"),
    "moe": ("olmoe_1b_7b", "train_4k"),
    "ssm": ("mamba2_130m", "decode_32k"),
    "hybrid": ("zamba2_7b", "decode_32k"),
    "vlm": ("qwen2_vl_2b", "prefill_32k"),
    "audio": ("hubert_xlarge", "train_4k"),
}


def _small_cell(kind):
    return ShapeCell("small", kind, 64 if kind != "decode" else 256, 8)


@pytest.fixture
def mesh22():
    """A (2, 2) ``("data", "model")`` cpu mesh over a fake group of 4."""
    from torch.distributed.device_mesh import init_device_mesh

    with dryrun.fake_world(4):
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_depth_series_extrapolates_exactly(family, mesh22):
    arch, shape = FAMILY_ARCHS[family]
    cfg = get_config(arch).reduced()
    cell = _small_cell(SHAPES[shape].kind)
    depths = dryrun.series_depths(cfg)
    third = depths[-1] + (cfg.shared_attn_every + 1 if family == "hybrid" else 1)
    terms = {n: dryrun.trace_costs(dataclasses.replace(cfg, n_layers=n), cell, mesh22, "cpu",
                                   memory=True) for n in depths + [third]}
    for r in terms.values():
        r.update({f"mem_{k}": v for k, v in r.pop("memory").items()})
    got = dryrun.extrapolate(dataclasses.replace(cfg, n_layers=third),
                             {n: terms[n] for n in depths})
    want = terms[third]
    if cell.kind == "prefill":
        # without autograd a layer frees what it makes: the peak of live
        # bytes is not a sum over layers, so only the other terms extrapolate
        for k in ("mem_temp_bytes", "mem_peak_hint_bytes"):
            got.pop(k), want.pop(k)
    assert got == pytest.approx(want, rel=0, abs=0.5)
    assert terms[third]["flops"] > 0 and terms[third]["mem_argument_bytes"] > 0


def _spec_local_bytes(cfg, cell, mesh):
    """The step inputs' bytes on one rank, from the specs alone: each
    dimension's size over the product of its mesh axes' sizes."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    specs = dryrun.cell_specs(cfg, cell)
    layout = dryrun.cell_pspecs(cfg, cell, specs, mesh)

    def walk(t, s):
        if isinstance(t, dict):
            return sum(walk(t[k], s[k]) for k in t)
        n = torch.empty((), dtype=t.dtype).element_size()
        for d, size in enumerate(t.shape):
            entry = s[d] if d < len(s) else None
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            n *= size // math.prod(sizes[a] for a in axes)
        return n

    return walk({k: specs[k] for k in layout}, layout)


CELL_ARCHS = {
    "dense": ("repro_gpt_100m", "train_4k"),
    "moe": ("olmoe_1b_7b", "decode_32k"),
    "ssm": ("mamba2_130m", "decode_32k"),
    "hybrid": ("zamba2_7b", "decode_32k"),
    "vlm": ("qwen2_vl_2b", "decode_32k"),
    "audio": ("hubert_xlarge", "train_4k"),
}


@pytest.mark.parametrize("family", list(CELL_ARCHS))
def test_a_cell_of_each_family_traces(family, tmp_path):
    from repro_torch.launch.mesh import make_production_mesh

    arch, shape = CELL_ARCHS[family]
    full = get_config(arch)
    small = full.reduced()          # narrow widths; the full config's blocks and positions
    cfg = dataclasses.replace(small, n_layers=dryrun.series_depths(small)[0],
                              q_block=full.q_block, kv_block=full.kv_block,
                              ssd_chunk=full.ssd_chunk, max_position=full.max_position)
    r = dryrun.run_cell(arch, shape, multi_pod=False, device_type="cpu", cfg_override=cfg,
                        out_dir=str(tmp_path))
    assert r["status"] == "ok" and r["chips"] == 256
    assert not dist.is_initialized()
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        want = _spec_local_bytes(cfg, SHAPES[shape], mesh)
    assert r["per_device_memory"]["argument_bytes"] == want
    assert r["per_device_accounting"]["flops"] > 0
    assert json.loads((tmp_path / f"{arch}.{shape}.16x16.json").read_text())["status"] == "ok"


REFERENCE_KEYS = {"arch", "shape", "kind", "mesh", "chips", "seq_len", "global_batch",
                  "params", "active_params", "model_flops", "per_device_memory",
                  "per_device_accounting", "per_device_production_raw", "status"}


def test_cli_writes_the_reference_keys(tmp_path):
    dryrun.main(["--arch", "mamba2_130m", "--shape", "long_500k", "--mesh", "single",
                 "--device-type", "cpu", "--out", str(tmp_path)])
    r = json.loads((tmp_path / "mamba2_130m.long_500k.16x16.json").read_text())
    assert REFERENCE_KEYS <= set(r)
    assert set(r["per_device_memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                           "alias_bytes", "peak_hint_bytes"}
    assert {"flops", "bytes_accessed", "coll_all-gather", "coll_all-reduce",
            "coll_reduce-scatter", "coll_all-to-all", "coll_collective-permute",
            "coll_count"} <= set(r["per_device_accounting"])
    assert r["status"] == "ok" and r["fits"] is True
    assert r["per_device_memory"]["peak_hint_bytes"] < dryrun.H100_MEMORY_BYTES


def test_no_process_group_outlives_the_file():
    assert not dist.is_initialized()
