"""Sharding in the port (``repro_torch.distributed.sharding``, the spec
functions of ``models.model``, ``train.step`` and ``serve.step``,
``launch.mesh`` and ``CheckpointManager.shard_restore``) against the
reference's.

* Specs, leaf by leaf and entry by entry, for all 11 configs on both
  production meshes (16x16 ``("data", "model")`` and 2x16x16 ``("pod",
  "data", "model")``), ZeRO-3 configs included: ``param_specs``,
  ``train_state_specs``, ``inference_param_specs``, ``decode_state_specs``
  (every config with a decode, B=128, L=1,024: the reference on
  ``jax.eval_shape``'s state, the port on ``init_decode_state(...,
  device="meta")``) and ``batch_pspecs``.  The reference's side runs on the
  duck-typed mesh its own tests use (``axis_names`` and a ``shape`` dict);
  the port's on real ``DeviceMesh``\\ es over a ``fake`` process group of
  world size 256 and 512 (``torch.testing._internal.distributed.fake_pg``),
  and on the duck-typed mesh too.
* The rule table's edges by name: ``resolve("batch", ("data", "model"))``
  is the 1-tuple ``("data",)``, mamba2's 50,280-row vocab stays
  unsharded, qwen15_4b's 20 kv heads send 'model' to the cache length, no
  mesh resolves to no axes, ``ff_inner`` is ``None``, scan axes pad with
  ``None``.
* ``lshard`` is ``x`` itself without a mesh and lays a DTensor out on a
  fake mesh with its values unchanged; ``placements`` of each spec.
* ``make_production_mesh`` / ``make_host_mesh`` / ``n_chips``;
  ``device_put_tree`` on a one-process gloo mesh; ``shard_restore`` of a
  reduced train state onto a (1, 2) mesh of two processes spawned with
  ``gloo`` and a ``file://`` rendezvous, bit for bit.
* A ``gpu`` test (skipped without a card): ``shard_restore`` onto a (1, 1)
  card mesh.

Every process group a test starts is destroyed in a fixture's teardown,
and the last test of the file checks that none is left for a later file
in the same worker.  The reference imports JAX in a ``try``: the card's
machine has no JAX, and there only the ``gpu`` test runs.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

try:                 # the card's machine has no JAX: only the ``gpu`` test runs there
    import jax
    from jax.sharding import PartitionSpec as RefP
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model
    from repro.serve.step import decode_state_specs as ref_decode_state_specs
    from repro.serve.step import inference_param_specs as ref_inference_param_specs
    from repro.train.step import batch_pspecs as ref_batch_pspecs
    from repro.train.step import train_state_specs as ref_train_state_specs
except ImportError:
    jax = None
from repro_torch import _util
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import init_decode_state, param_shapes, param_specs
from repro_torch.serve.step import decode_state_specs, inference_param_specs
from repro_torch.train import batch_pspecs, init_train_state, train_state_specs

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX for the reference")

ALL_CONFIGS = sorted(list_archs() + ["repro_gpt_100m"])
DECODE_CONFIGS = [a for a in ALL_CONFIGS if not get_config(a).encoder_only]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
JOIN_TIMEOUT_S = 240          # the two-process restore takes ~15 s; a hang fails the test


class DuckMesh:
    """The reference tests' mesh: ``axis_names`` and a ``shape`` dict."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


@pytest.fixture
def fake_mesh(request):
    """A ``DeviceMesh`` of a production shape over a ``fake`` process group
    (no collective runs), with the duck-typed mesh of the same shape; the
    group is destroyed however the test ends."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, names = MESHES[request.param]
    world = int(np.prod(shape))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        mesh = mesh_mod.make_production_mesh(multi_pod=len(shape) == 3, device_type="cpu")
        yield mesh, DuckMesh(shape, names)
    finally:
        dist.destroy_process_group()


@pytest.fixture
def local_group():
    """A one-process gloo group, destroyed however the test ends."""
    with mesh_mod.local_process_group("gloo"):
        yield


def _flat(tree):
    """The port's spec tree as {path: tuple}."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            assert isinstance(node, P), (path, node)
            out["/".join(path)] = tuple(node)

    walk(tree, ())
    return out


def _ref_flat(tree):
    """The reference's spec tree as {path: tuple}."""
    pairs = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(spec)
            for path, spec in pairs}


def _assert_same(want, got):
    assert sorted(got) == sorted(want)
    bad = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
    assert not bad, list(bad.items())[:5]


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = build_model(ref_get_config(arch))
    return _MODELS[arch]


# -- specs of all 11 configs on both production meshes --------------------------

@needs_jax
@pytest.mark.parametrize("fake_mesh", list(MESHES), indirect=True)
@pytest.mark.parametrize("arch", ALL_CONFIGS)
def test_param_specs_equal_reference(arch, fake_mesh):
    mesh, duck = fake_mesh
    want = _ref_flat(_model(arch).param_specs(duck))
    cfg = get_config(arch)
    _assert_same(want, _flat(param_specs(cfg, mesh)))
    _assert_same(want, _flat(param_specs(cfg, duck)))
    assert _flat(sharding.param_pspecs(param_shapes(cfg), zero3=cfg.zero3, mesh=mesh)) == \
        _flat(param_specs(cfg, mesh))


@needs_jax
@pytest.mark.parametrize("fake_mesh", list(MESHES), indirect=True)
@pytest.mark.parametrize("arch", ALL_CONFIGS)
def test_train_state_specs_equal_reference(arch, fake_mesh):
    mesh, duck = fake_mesh
    want = ref_train_state_specs(_model(arch), duck)
    got = train_state_specs(get_config(arch), mesh)
    assert sorted(got) == sorted(want) == ["opt", "params", "step"]
    assert got["step"] == P() and tuple(want["step"]) == ()
    for k in ("m", "v"):
        _assert_same(_ref_flat(want["opt"][k]), _flat(got["opt"][k]))
    _assert_same(_ref_flat(want["params"]), _flat(got["params"]))


@needs_jax
@pytest.mark.parametrize("fake_mesh", list(MESHES), indirect=True)
@pytest.mark.parametrize("arch", ALL_CONFIGS)
def test_inference_param_specs_equal_reference(arch, fake_mesh):
    mesh, duck = fake_mesh
    want = _ref_flat(ref_inference_param_specs(_model(arch), duck))
    got = _flat(inference_param_specs(get_config(arch), mesh))
    _assert_same(want, got)
    assert all("data" not in spec for path, spec in got.items() if "experts/" not in path)


@needs_jax
@pytest.mark.parametrize("fake_mesh", list(MESHES), indirect=True)
@pytest.mark.parametrize("arch", DECODE_CONFIGS)
def test_decode_state_specs_equal_reference(arch, fake_mesh):
    mesh, duck = fake_mesh
    model = _model(arch)
    ref_state = jax.eval_shape(lambda: model.init_decode_state(128, 1024))
    want = _ref_flat(ref_decode_state_specs(model, ref_state, duck))
    state = init_decode_state(get_config(arch), 128, 1024, device="meta")
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in ref_state.items()}
    _assert_same(want, _flat(decode_state_specs(get_config(arch), state, mesh)))


@needs_jax
@pytest.mark.parametrize("mesh_name", list(MESHES) + ["none"])
def test_batch_pspecs_equal_reference(mesh_name):
    duck = DuckMesh(*MESHES[mesh_name]) if mesh_name != "none" else None
    shapes = {"tokens": (256, 4096), "labels": (256, 4096), "pos_thw": (256, 4096, 3),
              "frames": (256, 4096, 512), "scalar": ()}
    want = ref_batch_pspecs({k: np.zeros(s, np.int8) for k, s in shapes.items()}, duck)
    got = batch_pspecs({k: torch.empty(s, dtype=torch.int8, device="meta")
                        for k, s in shapes.items()}, duck)
    _assert_same(_ref_flat(want), _flat(got))


# -- the rule table's edges, by name -------------------------------------------

def test_resolve_batch_is_a_one_tuple_on_a_one_pod_mesh():
    assert sharding.resolve("batch", ("data", "model")) == ("data",)
    assert sharding.resolve("batch", ("pod", "data", "model")) == ("pod", "data")
    assert sharding.resolve("batch", ("model",)) is None
    assert sharding.resolve("heads", ("data",)) is None and sharding.resolve(None, ("model",)) is None
    assert sharding.batch_pspec(DuckMesh((16, 16), ("data", "model"))) == P(("data",))


@pytest.mark.parametrize("fake_mesh", ["16x16"], indirect=True)
def test_reference_sharding_cases_by_name(fake_mesh):
    """``tests/test_serve_and_sharding.py``'s cases on the port's mesh:
    yi_6b's MLP and attention, deepseek's expert precedence, mamba2's
    indivisible vocab, ZeRO-3 stripped for serving, qwen15_4b's cache
    length taking 'model'."""
    mesh, _ = fake_mesh
    yi = param_specs(get_config("yi_6b"), mesh)
    assert yi["layers"]["mlp"]["w_gate"] == P(None, "data", "model")
    assert yi["layers"]["mlp"]["w_down"] == P(None, "model", "data")
    assert yi["layers"]["attn"]["wq"]["w"] == P(None, "data", "model")
    assert yi["embed"]["table"] == P("model", "data")
    ds = param_specs(get_config("deepseek_v2_236b"), mesh)
    assert ds["moe_layers"]["moe"]["experts"]["w_gate"] == P(None, "model", "data", None)
    assert param_shapes(get_config("mamba2_130m"))["embed"]["table"][0] == 50_280
    assert param_specs(get_config("mamba2_130m"), mesh)["embed"]["table"][0] is None
    serve = inference_param_specs(get_config("deepseek_v2_236b"), mesh)
    assert "data" not in [a for a in serve["moe_layers"]["attn"]["w_uq"]["w"] if a]
    assert serve["moe_layers"]["moe"]["experts"]["w_gate"] == P(None, "data", None, "model")
    cfg = get_config("qwen15_4b")                    # kv 20 does not divide 16
    state = init_decode_state(cfg, 128, 1024, device="meta")
    assert decode_state_specs(cfg, state, mesh)["kv_k"] == P(None, "data", "model", None, None)


def test_no_mesh_resolves_to_no_axes_and_a_current_mesh_to_size_one():
    """Without a mesh ``param_pspecs`` resolves no axis; under ``use_mesh``
    of a duck-typed mesh it resolves the names with every size taken as 1
    (so every dim divides), as the reference does under an abstract mesh."""
    cfg = get_config("mamba2_130m")
    assert all(a is None for spec in _flat(param_specs(cfg)).values() for a in spec)
    with sharding.use_mesh(DuckMesh((16, 16), ("data", "model"))):
        assert sharding.axis_size("model") == 16 and sharding.axis_size("pod") == 1
        specs = param_specs(cfg)
    assert specs["embed"]["table"] == P("model", None)          # 50,280 kept: sizes are 1
    assert sharding.current_mesh() is None and sharding.axis_size("model") == 1


def test_ff_inner_is_none_and_scan_axes_pad_with_none():
    shape = (4, 3, 64, 128)                     # two leading scan axes
    spec = sharding._spec_for("layers/mlp/w_gate", shape, True, ("data", "model"),
                              {"data": 2, "model": 2})
    assert spec == P(None, None, "data", "model")
    rules = [(r"x$", (("ff_inner",), ("ff",)))]
    saved = sharding._PARAM_RULES
    try:
        sharding._PARAM_RULES = rules
        assert sharding._spec_for("a/x", (8, 8), False, ("model",), {"model": 2}) == \
            P(None, "model")
    finally:
        sharding._PARAM_RULES = saved


def test_axis_rules_are_thread_local_and_restored():
    import threading

    rules = dict(sharding.DEFAULT_RULES, heads="data")
    seen = []
    with sharding.axis_rules(rules):
        assert sharding.resolve("heads", ("data", "model")) == "data"
        t = threading.Thread(target=lambda: seen.append(sharding.active_rules()))
        t.start()
        t.join(10)
    assert seen == [None] and sharding.active_rules() is None
    assert sharding.resolve("heads", ("data", "model")) == "model"


def test_placements_of_each_spec_form():
    from torch.distributed.tensor import Replicate, Shard

    m2, m3 = DuckMesh((16, 16), ("data", "model")), DuckMesh((2, 16, 16), ("pod", "data", "model"))
    assert sharding.placements(P(None, "model"), m2) == [Replicate(), Shard(1)]
    assert sharding.placements(P(("data",), None, "model"), m2) == [Shard(0), Shard(2)]
    assert sharding.placements(P(("pod", "data"), "model"), m3) == [Shard(0), Shard(0), Shard(1)]
    assert sharding.placements(P(), m3) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sharding.placements(P(("data", "pod")), m3)
    with pytest.raises(ValueError, match="two dimensions"):
        sharding.placements(P("model", "model"), m2)


def test_lshard_is_x_itself_without_a_mesh():
    x = torch.ones(4, 4)
    assert sharding.lshard(x, "batch", None) is x
    with sharding.use_mesh(DuckMesh((16, 16), ("data", "model"))):
        assert sharding.lshard(x, "batch", None) is x            # a plain tensor passes


@pytest.mark.parametrize("fake_mesh", ["16x16", "2x16x16"], indirect=True)
def test_lshard_lays_out_a_dtensor_on_a_fake_mesh(fake_mesh):
    """Replicated → ``("batch", "heads")``: a local cut (no collective), so
    rank 0's shard holds the full tensor's first block, unchanged."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh, _ = fake_mesh
    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    d = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
    with sharding.use_mesh(mesh):
        y = sharding.lshard(d, "batch", "heads")
    batch_ways = int(np.prod(mesh.shape[:-1]))
    assert list(y.placements) == [Shard(0)] * (mesh.ndim - 1) + [Shard(1)]
    assert torch.equal(y.to_local(), x[: 64 // batch_ways, : 32 // 16])


# -- meshes --------------------------------------------------------------------

@pytest.mark.parametrize("fake_mesh", list(MESHES), indirect=True)
def test_production_mesh_shapes_and_names(fake_mesh):
    mesh, duck = fake_mesh
    assert tuple(mesh.mesh_dim_names) == duck.axis_names
    assert tuple(mesh.shape) == tuple(duck.shape.values())
    assert mesh_mod.n_chips(mesh) == mesh_mod.n_chips(duck) == dist.get_world_size()
    with pytest.raises(ValueError, match="world size"):
        mesh_mod.make_production_mesh(multi_pod=mesh.ndim == 2, device_type="cpu")


def test_mesh_functions_need_a_process_group():
    assert not dist.is_initialized()          # importing launch.mesh started none
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_host_mesh(device_type="cpu")
    assert mesh_mod.SINGLE_POD == (16, 16) and mesh_mod.MULTI_POD == (2, 16, 16)


def test_make_host_mesh_and_n_chips(local_group):
    mesh = mesh_mod.make_host_mesh(device_type="cpu")
    assert mesh_mod.n_chips(mesh) == 1
    assert tuple(mesh.mesh_dim_names) == ("data", "model") and tuple(mesh.shape) == (1, 1)


def test_device_put_tree_on_a_host_mesh(local_group):
    from torch.distributed.tensor import DTensor

    mesh = mesh_mod.make_host_mesh(device_type="cpu")
    tree = {"a": {"w": torch.randn(8, 6).to(torch.bfloat16)}, "b": torch.arange(5),
            "c": torch.zeros(())}
    specs = {"a": {"w": P(("data",), "model")}, "b": None, "c": P()}
    out = sharding.device_put_tree(tree, mesh, specs)
    assert out["b"] is tree["b"]
    for key, spec in (("a", specs["a"]["w"]), ("c", specs["c"])):
        leaf = out[key]["w"] if key == "a" else out[key]
        want = tree[key]["w"] if key == "a" else tree[key]
        assert isinstance(leaf, DTensor)
        assert list(leaf.placements) == sharding.placements(spec, mesh)
        assert torch.equal(leaf.full_tensor(), want)
    with pytest.raises(ValueError, match="prefix"):
        sharding.device_put_tree(tree, mesh, {"a": None})


# -- shard_restore on two processes ----------------------------------------------

SHARD_CFG = dict(chunk_param_bytes=1 << 12, backend="huffman")


def _saved_state(tmp_path):
    """A reduced repro_gpt_100m train state, saved as a base and a delta
    (the moments chained), with the last state kept for the check."""
    from repro_torch.core import zipnn

    cfg = get_config("repro_gpt_100m").reduced()
    state = init_train_state(cfg, 3, device="cpu")
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path / "ckpt"), base_every=2,
                                             zipnn=zipnn.ZipNNConfig(**SHARD_CFG),
                                             device="cpu"))
    mgr.save(0, state)
    mgr.wait()
    for leaf in _util.tree_leaves(state["opt"]):
        leaf.mul_(0.5).add_(1e-3)
    state["step"].fill_(1)
    mgr.save(1, state)
    mgr.wait()
    torch.save(state, tmp_path / "want.pt")
    return cfg


def _shard_restore_worker(rank: int, world: int, directory: str) -> None:
    """One rank: restore onto a (1, ``world``) mesh and check every leaf;
    the result goes to ``rank<r>.json``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core import zipnn

    out = {"rank": rank}
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
        specs = train_state_specs(get_config("repro_gpt_100m").reduced(), mesh)
        mgr = CheckpointManager(CheckpointConfig(os.path.join(directory, "ckpt"),
                                                 zipnn=zipnn.ZipNNConfig(**SHARD_CFG),
                                                 device="cpu"))
        step, tree = mgr.shard_restore(None, mesh, specs)
        want = dict(_util.tree_flatten_with_keys(torch.load(os.path.join(directory, "want.pt"))))
        got = _util.tree_flatten_with_keys(tree)
        bad, sharded = [], 0
        for key, leaf in got:
            spec = _spec_at(specs, key)
            ok = (isinstance(leaf, DTensor)
                  and list(leaf.placements) == sharding.placements(spec, mesh)
                  and leaf.dtype == want[key].dtype
                  and torch.equal(leaf.full_tensor().reshape(-1).view(torch.uint8),
                                  want[key].reshape(-1).view(torch.uint8)))
            if not ok:
                bad.append(key)
            sharded += any(a is not None for a in spec)
        out.update(step=step, leaves=len(got), specs=len(_flat(specs)), bad=bad,
                   sharded=sharded)
    finally:
        dist.destroy_process_group()
        with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)


def _spec_at(specs, key):
    node = specs
    for k in key.split("/"):
        node = node[k]
    return node


@needs_jax
def test_shard_restore_onto_two_gloo_processes_is_bit_exact(tmp_path):
    import multiprocessing

    _saved_state(tmp_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_shard_restore_worker, args=(r, 2, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        assert not any(p.is_alive() for p in procs), "a rank hung"
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    for r in results:
        assert r["step"] == 1 and r["bad"] == [], r
        assert r["leaves"] == r["specs"] and r["sharded"] > 0


# -- the card ------------------------------------------------------------------

@pytest.mark.gpu
def test_shard_restore_onto_a_card_mesh(tmp_path):
    """A reduced train state saved on the card, ``shard_restore`` onto a
    (1, 1) card mesh: DTensors with the specs' placements, local shards on
    the card, ``full_tensor()`` equal to ``restore(device_resident=True)``
    bit for bit, K1's one-shot decode and K2 launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.distributed.tensor import DTensor

    from repro_torch.core import zipnn
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = get_config("repro_gpt_100m").reduced()
    state = init_train_state(cfg, 3, device="cuda")
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), zipnn=zipnn.ZipNNConfig(**SHARD_CFG),
                                             device="cuda"))
    mgr.save(0, state)
    mgr.wait()
    _, want = mgr.restore(device_resident=True)
    with mesh_mod.local_process_group("nccl"):
        mesh = mesh_mod.make_host_mesh(device_type="cuda")
        specs = train_state_specs(cfg, mesh)
        reset_launch_counts()
        step, got = mgr.shard_restore(None, mesh, specs)
        counts = launch_counts()
        for (key, leaf), (_, w) in zip(_util.tree_flatten_with_keys(got),
                                       _util.tree_flatten_with_keys(want)):
            spec = _spec_at(specs, key)
            assert isinstance(leaf, DTensor) and leaf.to_local().is_cuda, key
            assert list(leaf.placements) == sharding.placements(spec, mesh), key
            assert torch.equal(leaf.full_tensor().reshape(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8)), key
    assert step == 0 and counts["huffdecode_serial"] > 0 and counts["plane_consumer"] > 0


def test_no_process_group_outlives_this_file():
    """Last in the file: a later file in the same worker starts with no
    default process group and no current mesh."""
    assert not dist.is_initialized()
    assert sharding.current_mesh() is None and sharding.active_rules() is None
