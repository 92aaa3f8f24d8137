"""The serving and checkpoint paths of the SSM and hybrid families at
``reduced()`` size: the store against the reference's, the SSM ring
against the port's own plain step, the reference's rejections, a hybrid
checkpoint against the reference's directory, and the serving entry point
restoring a hybrid checkpoint.

* Store: ``CompressedParamStore.from_params`` of an SSM model compresses
  ``layers`` per layer, the f32 ``ssm`` leaves included, byte-identical to
  the reference's; a hybrid model's nested stacks stay in ``static``, as
  the reference's ``DEFAULT_STACK_KEYS`` leave them.
* Ring (whole layers and tiles): logits bit-identical to
  :func:`repro_torch.models.decode_step`, and the final ``ssm_state`` and
  ``ssm_conv`` equal bit for bit.
* Checkpoint: ``manifest.json`` and ``data.bin`` of a hybrid model's params
  equal the reference's byte for byte, and each package restores the
  other's.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

try:                 # the card's machine has no JAX: only the ``gpu`` tests run there
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import manager as ref_manager
    from repro.configs import get_config as ref_get_config
    from repro.core import zipnn as ref_zipnn
    from repro.core.options import CodecOptions as RefOptions
    from repro.models import build_model
    from repro.serve.compressed import CompressedParamStore as RefStore
    from repro.serve.step import greedy_generate as ref_greedy_generate
    from repro.serve.step import make_compressed_serve_step as ref_make_compressed_serve_step
    from repro.serve.step import make_kv_tiered_serve_step as ref_make_kv_tiered_serve_step
except ImportError:
    jax = None
from repro_torch import _util, convert
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import zipnn
from repro_torch.launch import serve as launch_serve
from repro_torch.models import decode_step, init_decode_state
from repro_torch.models.model import init_params
from repro_torch.serve import (
    CompressedParamStore,
    KVCacheStore,
    greedy_generate,
    make_compressed_serve_step,
    make_kv_tiered_serve_step,
)
from repro_torch.serve.compressed import DEFAULT_STACK_KEYS

HUFF = zipnn.ZipNNConfig(chunk_param_bytes=512, backend="huffman")
CKPT = dict(chunk_param_bytes=1 << 12, backend="huffman")


def _pair(name, n_layers=None):
    jcfg = ref_get_config(name).reduced()
    cfg = get_config(name).reduced()
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


def _numpy_params(jcfg, seed=0):
    """``standard_normal * 0.02`` per leaf of the reference's tree (the
    ``ssm`` leaves in f32): the numpy tree, the reference's arrays and the
    port's tensors."""
    leaves, treedef = jax.tree_util.tree_flatten(build_model(jcfg).abstract_params())
    rng = np.random.default_rng(seed)
    nptree = jax.tree_util.tree_unflatten(treedef, [
        (rng.standard_normal(l.shape) * 0.02).astype(np.dtype(l.dtype)) for l in leaves])
    return (nptree, jax.tree_util.tree_map(jnp.asarray, nptree),
            convert.params_from_numpy(nptree, device="cpu"))


def _toks(cfg, steps, B=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (steps, B, 1)).astype(np.int32))


@pytest.fixture(scope="module")
def mamba():
    cfg = get_config("mamba2_130m").reduced()
    params = init_params(cfg, 0, device="cpu")
    return cfg, params, CompressedParamStore.from_params(params, HUFF, payload_feed=True,
                                                         device="cpu")


# -- the store -----------------------------------------------------------------

def _ref_huff():
    return ref_zipnn.ZipNNConfig(chunk_param_bytes=512, backend="huffman")


@pytest.mark.parametrize("coder", ["huffman", "default"])
def test_ssm_store_equals_the_reference(coder):
    """``layers`` compressed per layer as the reference's store does, the
    f32 ``A_log`` / ``D`` / ``dt_bias`` blobs included."""
    config, ref_config = (HUFF, _ref_huff()) if coder == "huffman" else (
        zipnn.DEFAULT, ref_zipnn.DEFAULT)
    _, jparams, params = _numpy_params(ref_get_config("mamba2_130m").reduced())
    ref = RefStore.from_params(jparams, ref_config, options=RefOptions(backend="host"))
    port = CompressedParamStore.from_params(params, config, device="cpu")
    assert port.stack_keys == ref.stack_keys == ("layers",)
    assert sorted(port.static) == sorted(ref.static) == ["embed", "final_norm", "lm_head"]
    dtypes = set()
    for i in range(port.n_layers("layers")):
        got = port.manifest("layers", i)["leaves"]
        want = ref._stacks["layers"][i]["leaves"]
        assert [ct.blob for ct in got] == [ct.blob for ct in want], i
        dtypes |= {ct.dtype for ct in got}
    assert dtypes == {"bfloat16", "float32"}
    assert port.comp_bytes == ref.comp_bytes < port.raw_bytes == ref.raw_bytes
    assert port.static_bytes == ref.static_bytes


def test_hybrid_store_keeps_its_nested_stacks_static():
    """``mamba_groups``, ``mamba_tail`` and ``shared_attn`` are not in
    :data:`DEFAULT_STACK_KEYS`: both packages keep a hybrid model whole in
    ``static`` and compress nothing."""
    _, jparams, params = _numpy_params(_pair("zamba2_7b", 5)[0])
    ref = RefStore.from_params(jparams, _ref_huff(), options=RefOptions(backend="host"))
    port = CompressedParamStore.from_params(params, HUFF, device="cpu")
    assert not {"mamba_groups", "mamba_tail", "shared_attn"} & set(DEFAULT_STACK_KEYS)
    assert port.stack_keys == ref.stack_keys == ()
    assert sorted(port.static) == sorted(ref.static) == sorted(params)
    assert port.comp_bytes == ref.comp_bytes == 0
    assert port.static_bytes == ref.static_bytes == sum(
        t.numel() * t.element_size() for t in _util.tree_leaves(params))


# -- the SSM ring --------------------------------------------------------------

def _plain(cfg, params, toks, length):
    state = init_decode_state(cfg, toks.shape[1], length, start_pos=0, device="cpu")
    out = []
    for t in toks:
        logits, state = decode_step(cfg, params, state, t)
        out.append(logits)
    return out, state


@pytest.mark.parametrize("tiles", [1, 4])
def test_ssm_ring_bit_identical_to_plain(mamba, tiles):
    """Logits at every step and the final recurrent state and conv history
    bit-identical to the plain step; at most ``ring x tiles`` slots."""
    cfg, params, store = mamba
    toks = _toks(cfg, 6)
    want, state = _plain(cfg, params, toks, 6)
    cstep = make_compressed_serve_step(cfg, store, ring=2, tiles=tiles)
    store.reset_peak()
    got = init_decode_state(cfg, 2, 6, start_pos=0, device="cpu")
    for s, t in enumerate(toks):
        logits, got = cstep(got, t)
        assert torch.equal(logits.view(torch.int32), want[s].view(torch.int32)), s
    assert sorted(got) == sorted(state) == ["pos", "ssm_conv", "ssm_state"]
    assert torch.equal(got["ssm_state"].view(torch.int32), state["ssm_state"].view(torch.int32))
    assert torch.equal(got["ssm_conv"].view(torch.int16), state["ssm_conv"].view(torch.int16))
    assert 0 < store.peak_resident <= 2 * tiles


def test_ssm_ring_through_greedy_generate(mamba):
    cfg, params, store = mamba
    prompt = _toks(cfg, 4, seed=1)[:, :, 0].T.contiguous()
    la, lb = [], []
    ta, sa = greedy_generate(cfg, params, prompt, 5, logits_out=la)
    tb, sb = greedy_generate(cfg, None, prompt, 5, logits_out=lb,
                             serve_step=make_compressed_serve_step(cfg, store, tiles=3))
    assert torch.equal(ta, tb) and all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_ssm_ring_without_prefetch(mamba):
    cfg, params, store = mamba
    toks = _toks(cfg, 3, seed=4)
    want, _ = _plain(cfg, params, toks, 3)
    cstep = make_compressed_serve_step(cfg, store, prefetch=False)
    got = init_decode_state(cfg, 2, 3, start_pos=0, device="cpu")
    for s, t in enumerate(toks):
        logits, got = cstep(got, t)
        assert torch.equal(logits, want[s])


# -- the reference's rejections ------------------------------------------------

def test_hybrid_ring_is_rejected_as_the_reference_rejects_it(mamba):
    """Both packages refuse a hybrid model in the ring, with one message."""
    jcfg, cfg = _pair("zamba2_7b")
    _, _, store = mamba
    with pytest.raises(NotImplementedError, match="shared_attn params repeat") as port:
        make_compressed_serve_step(cfg, store)
    with pytest.raises(NotImplementedError, match="shared_attn params repeat") as ref:
        ref_make_compressed_serve_step(build_model(jcfg), None)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("name", ["mamba2_130m", "zamba2_7b"])
def test_kv_tier_is_rejected_for_ssm_and_hybrid(mamba, name):
    """The tiered step (plain params) and the SSM ring's ``kv_store`` raise
    as the reference's do; a ``KVCacheStore`` refuses a state with an SSM
    state in it."""
    jcfg, cfg = _pair(name)
    dense = get_config("repro_gpt_100m").reduced()
    kv = KVCacheStore(init_decode_state(dense, 2, 4, start_pos=0, device="cpu"))
    with pytest.raises(NotImplementedError, match="attention-cache length axis") as port:
        make_kv_tiered_serve_step(cfg, {}, kv)
    with pytest.raises(NotImplementedError, match="attention-cache length axis") as ref:
        ref_make_kv_tiered_serve_step(build_model(jcfg), {}, None)
    assert str(port.value) == str(ref.value)
    with pytest.raises(NotImplementedError, match="no cache-length axis"):
        KVCacheStore(init_decode_state(cfg, 2, 4, start_pos=0, device="cpu"))
    if name == "mamba2_130m":
        _, _, store = mamba
        with pytest.raises(NotImplementedError, match="ssm state has no cache-length axis"):
            make_compressed_serve_step(cfg, store, kv_store=kv)


# -- checkpoints and the serving entry point -----------------------------------

def _files(directory, step):
    d = os.path.join(directory, f"step_{step}")
    return [open(os.path.join(d, n), "rb").read() for n in ("manifest.json", "data.bin")]


def _ref_save(directory, step, nptree):
    ref = ref_manager.CheckpointManager(ref_manager.CheckpointConfig(
        str(directory), zipnn=ref_zipnn.ZipNNConfig(**CKPT)))
    ref.save(step, {"params": nptree}, blocking=True)


@pytest.fixture(scope="module")
def hybrid_ckpts(tmp_path_factory):
    """The params of reduced zamba2 with a tail, saved as one base by each
    package: (numpy tree, reference dir, port dir)."""
    jcfg, _ = _pair("zamba2_7b", 5)
    nptree, _, params = _numpy_params(jcfg, seed=2)
    root = tmp_path_factory.mktemp("hybrid_ckpt")
    _ref_save(root / "ref", 7, nptree)
    port = CheckpointManager(CheckpointConfig(
        str(root / "port"), zipnn=zipnn.ZipNNConfig(**CKPT), device="cpu"))
    port.save(7, {"params": params}, blocking=True)
    port.wait()
    return nptree, str(root / "ref"), str(root / "port")


def test_hybrid_checkpoint_equals_the_reference(hybrid_ckpts):
    """The same flat keys (``params/mamba_groups/mamba/in_proj/w``, ...),
    ``manifest.json`` and ``data.bin`` byte for byte, the f32 ``ssm``
    leaves stored as f32."""
    nptree, ref_dir, port_dir = hybrid_ckpts
    assert _files(port_dir, 7) == _files(ref_dir, 7)
    entries = json.loads(_files(port_dir, 7)[0])["entries"]
    keys = [e["key"] for e in entries]
    assert keys == sorted(f"params/{k}" for k, _ in _util.tree_flatten_with_keys(nptree))
    assert "params/mamba_groups/mamba/in_proj/w" in keys and "params/mamba_tail/norm/g" in keys
    dtypes = {e["key"]: e["dtype"] for e in entries}
    assert dtypes["params/mamba_tail/mamba/ssm/A_log"] == "float32"
    assert dtypes["params/shared_attn/attn/wq/w"] == "bfloat16"


def test_each_package_restores_the_others_hybrid_checkpoint(hybrid_ckpts):
    nptree, ref_dir, port_dir = hybrid_ckpts
    want = {k: np.asarray(v) for k, v in _util.tree_flatten_with_keys(nptree)}
    step, tree = CheckpointManager(CheckpointConfig(ref_dir, device="cpu")).restore(
        device_resident=True)
    got = dict(_util.tree_flatten_with_keys(tree["params"]))
    assert step == 7 and sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape and g.dtype == convert.params_from_numpy(
            {"x": w[:0]}, device="cpu")["x"].dtype, k
        assert np.array_equal(g.reshape(-1).view(torch.uint8).numpy(),
                              np.ascontiguousarray(w).reshape(-1).view(np.uint8)), k
    _, tree = ref_manager.CheckpointManager(ref_manager.CheckpointConfig(port_dir)).restore()
    assert all(np.array_equal(np.asarray(v).view(np.uint8), want[k].view(np.uint8))
               for k, v in _util.tree_flatten_with_keys(tree["params"]))


def test_serve_entry_point_restores_a_hybrid_checkpoint(tmp_path, capsys):
    """``launch.serve.main`` on the reference's directory of reduced zamba2:
    the restored params equal the saved ones bit for bit, and the tokens
    equal the reference's ``greedy_generate`` on the same params and
    prompt."""
    jcfg, cfg = _pair("zamba2_7b")
    nptree, jparams, _ = _numpy_params(jcfg, seed=3)
    _ref_save(tmp_path, 4, nptree)
    served = {}
    out = launch_serve.main(["--arch", "zamba2_7b", "--reduced", "--ckpt-dir", str(tmp_path),
                             "--device", "cpu", "--batch", "2", "--prompt-len", "3",
                             "--gen", "5"], params_out=served)
    text = capsys.readouterr().out
    assert "[serve] restored step 4 from ZipNN checkpoint" in text
    assert "[serve] generated 2x5 tokens" in text
    got, want = (_util.tree_flatten_with_keys(t) for t in (served, nptree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert np.array_equal(g.reshape(-1).view(torch.uint8).numpy(),
                              np.ascontiguousarray(w).reshape(-1).view(np.uint8)), k
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    ref, _ = ref_greedy_generate(build_model(jcfg), jparams, jnp.asarray(prompt), 5)
    assert out.shape == (2, 5) and out.dtype == torch.int32
    assert np.array_equal(np.asarray(ref), out.numpy())


@pytest.mark.parametrize("name", ["mamba2_130m", "zamba2_7b"])
def test_serve_entry_point_runs_random_init(name, capsys):
    out = launch_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "3", "--gen", "4"])
    cfg = get_config(name).reduced()
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 3)).astype(np.int32))
    want, _ = greedy_generate(cfg, init_params(cfg, 0, device="cpu"), prompt, 4)
    assert torch.equal(out, want)
    assert "[serve] random init" in capsys.readouterr().out


# -- on the card (``gpu``) -----------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", [1, 4])
def test_ssm_ring_on_card_bit_identical_to_plain(cuda, tiles):
    """The store built on the card (K3, K7, K1's index pass; the f32
    ``ssm`` leaves through K3's 4-byte path) and the ring (K1 sync, K2) on
    the card: blobs equal the host's, logits and final states bit-identical
    to the plain step on the card."""
    from repro_torch.core.options import CodecOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = get_config("mamba2_130m").reduced()
    params = init_params(cfg, 0, device=cuda)
    store = CompressedParamStore.from_params(params, HUFF, options=CodecOptions(
        backend="device"), payload_feed=True, device=cuda)
    host = CompressedParamStore.from_params(_util.tree_map(lambda a: a.cpu(), params), HUFF,
                                            options=CodecOptions(backend="host"), device="cpu")
    for i in range(cfg.n_layers):
        assert [ct.blob for ct in store.manifest("layers", i)["leaves"]] == [
            ct.blob for ct in host.manifest("layers", i)["leaves"]]
    toks = _toks(cfg, 5).to(cuda)
    state = init_decode_state(cfg, 2, 5, start_pos=0, device=cuda)
    got = dict(state)
    cstep = make_compressed_serve_step(cfg, store, tiles=tiles)
    reset_launch_counts()
    for t in toks:
        want, state = decode_step(cfg, params, state, t)
        logits, got = cstep(got, t)
        assert torch.equal(logits.view(torch.int32), want.view(torch.int32))
    for k in ("ssm_state", "ssm_conv"):
        assert torch.equal(got[k], state[k])
    counts = launch_counts()
    assert counts["huffdecode_chunks"] > 0 and counts["plane_consumer"] > 0


@pytest.mark.gpu
def test_hybrid_checkpoint_on_card_equals_the_host(cuda, tmp_path):
    """A card save of reduced zamba2's params (K3, K7) writes the host's
    bytes; a card restore (K1's one-shot decode, K2) gives them back bit
    for bit on the card."""
    cfg = dataclasses.replace(get_config("zamba2_7b").reduced(), n_layers=5)
    params = init_params(cfg, 1, device=cuda)
    card = CheckpointManager(CheckpointConfig(str(tmp_path / "card"),
                                              zipnn=zipnn.ZipNNConfig(**CKPT), device=cuda))
    card.save(1, {"params": params}, blocking=True)
    host = CheckpointManager(CheckpointConfig(str(tmp_path / "host"),
                                              zipnn=zipnn.ZipNNConfig(**CKPT), device="cpu"))
    host.save(1, {"params": _util.tree_map(lambda a: a.cpu(), params)}, blocking=True)
    assert _files(str(tmp_path / "card"), 1) == _files(str(tmp_path / "host"), 1)
    _, tree = card.restore(device_resident=True)
    for (k, a), (_, b) in zip(_util.tree_flatten_with_keys(tree["params"]),
                              _util.tree_flatten_with_keys(params)):
        assert a.is_cuda and torch.equal(a.view(torch.uint8), b.view(torch.uint8)), k
