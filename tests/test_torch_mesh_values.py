"""The models on DTensors over a real mesh hold against the plain path.

The dry-run (``repro_torch.launch.dryrun``) traces the models on DTensors
over fake process groups, where no value is computed.  Here four CPU
processes joined by ``gloo`` (a ``file://`` rendezvous) lay a reduced
config of each family out on a (2, 2) ``("data", "model")`` mesh by the
same spec functions the dry-run uses, run the forward (the prefill's
params), the loss with its gradients (the train state's params, ZeRO-3
over 'data') and one decode step (the serving layouts) on DTensors, and
hold each result's ``full_tensor()`` against the plain path on the same
inputs.  So a wrong ``Partial`` or ``Replicate`` declaration, a wrong
vocab offset in the vocab-parallel lookup, or a gradient reduced twice
shows as a wrong number.

The configs cover every mesh-only path: heads and kv groups that divide
the 'model' axis and kv groups that do not (granite_20b's one kv head:
k and v expanded to the query heads, the decode cache cut by length),
query heads that do not (3- and 1-head variants: the heads cut unevenly,
a rank with none), the
sequence-parallel carry, the vocab-parallel lookup and fused CE, the
shard-local MoE dispatch (olmoe_1b_7b) with MLA (deepseek_v2_236b), the
SSM and hybrid stacks, and the vlm and audio front ends.

Tolerance: the mesh splits some f32 and bf16 sums (a row-parallel
product's halves, the loss's token sums), which round in another order.
Each result is held in the 2-norm to ``TOL`` of its own norm, which a
factor of 2 (a sum counted twice, a partial sum left unreduced) or a
wrong row of the table exceeds ten times over.  Measured: at most 0.8%
for every result but the query projection's gradient where the config
has attention biases (granite_20b, qwen2_vl_2b, hubert_xlarge: up to
3.2%): a softmax row's gradient sums to zero, so ``dq = ds @ k`` cancels
the keys' common part, the bias, and the carry's rounding shows there;
with the biases zeroed it is 0.5%.  For the same reason the key bias's
gradient is zero in exact arithmetic without RoPE: it is held against the
query bias's gradient.  The decode's new caches are held the same way:
past the first layer, their inputs carry the row-parallel sums' rounding.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import time

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config

WORLD = 4
MESH = (2, 2)
JOIN_TIMEOUT_S = 300.0
TOL = 5e-2                     # relative, in the 2-norm
B, S, CACHE = 4, 16, 32        # batch, train/prefill length, decode cache length


def _heads(n: int):
    """A dense config of ``n`` query heads and one kv head: 3 do not
    divide the 'model' axis (cut 2 and 1), and of 1 the second rank holds
    none."""
    cfg = get_config("h2o_danube3_4b").reduced()
    return lambda: dataclasses.replace(cfg, n_heads=n, n_kv_heads=1)


CASES = {
    "dense": lambda: get_config("h2o_danube3_4b").reduced(),
    "dense_one_kv_head": lambda: get_config("granite_20b").reduced(),
    "dense_three_heads": _heads(3),
    "dense_one_head": _heads(1),
    "moe": lambda: get_config("olmoe_1b_7b").reduced(),
    "moe_expert_parallel": lambda: get_config("olmoe_1b_7b").reduced(),
    "moe_mla": lambda: get_config("deepseek_v2_236b").reduced(),
    "ssm": lambda: get_config("mamba2_130m").reduced(),
    "hybrid": lambda: get_config("zamba2_7b").reduced(),
    "vlm": lambda: get_config("qwen2_vl_2b").reduced(),
    "audio": lambda: get_config("hubert_xlarge").reduced(),
}


# cases run with ``moe.SERVING_TOKENS`` at 0: the training layout (experts
# over 'model', tokens over 'data'), which the reference's threshold keeps
# for shards of 4,096 tokens and more
TRAINING_LAYOUT = ("moe_expert_parallel",)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """``|got - want| / |want|`` in the 2-norm, in f64 (0 for two zeros)."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} against {tuple(want.shape)}")
    scale = torch.linalg.vector_norm(want).item()
    err = torch.linalg.vector_norm(got - want).item()
    return err / scale if scale else err


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _batch(cfg) -> dict:
    """One global batch of ``batch_specs``' shapes, drawn from a fixed
    seed (the same on every rank)."""
    import numpy as np

    from repro_torch.data.pipeline import DataConfig, batch_specs

    rng = np.random.default_rng(0)
    out = {}
    for k, (shape, dtype) in batch_specs(cfg, DataConfig(seq_len=S, global_batch=B)).items():
        if dtype.is_floating_point:
            out[k] = torch.from_numpy(rng.standard_normal(shape) * 0.5).to(dtype)
        else:
            hi = S if k == "pos_thw" else cfg.vocab_size
            out[k] = torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32))
    return out


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _case(cfg, mesh) -> dict:
    """One config's gaps, mesh against plain: ``{result: gap}``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import device_put_tree, use_mesh
    from repro_torch.models import model
    from repro_torch.serve.step import decode_state_specs, inference_param_specs
    from repro_torch.train.step import batch_pspecs, loss_and_grads, train_state_specs

    if cfg.moe:
        cfg = dataclasses.replace(cfg, dispatch_shards=MESH[0])   # one a batch shard
    params = model.init_params(cfg, 0, device="cpu")
    batch = _batch(cfg)
    gaps = {}

    def put(tree, specs):
        return device_put_tree(tree, mesh, specs)

    with use_mesh(mesh), implicit_replication():
        # the forward on the prefill's layouts
        want, want_aux = model.forward(cfg, params, batch)
        got, got_aux = model.forward(cfg, put(params, model.param_specs(cfg, mesh)),
                                     put(batch, batch_pspecs(batch, mesh)))
        gaps["logits"] = _gap(_whole(got), want)
        gaps["aux"] = _gap(_whole(got_aux), want_aux)

        # the loss and its gradients on the train state's layouts
        specs = train_state_specs(cfg, mesh)["params"]
        want_l, _, want_g = loss_and_grads(cfg, params, batch)
        got_l, _, got_g = loss_and_grads(cfg, put(params, specs),
                                         put(batch, batch_pspecs(batch, mesh)))
        gaps["loss"] = _gap(_whole(got_l), want_l)
        got_g, want_g = dict(_leaves(got_g)), dict(_leaves(want_g))
        for name, g in want_g.items():
            gaps[f"grad {name}"] = _gap(_whole(got_g[name]), g)
            if name.endswith("attn/wk/b") and not cfg.use_rope:
                # zero in exact arithmetic (a softmax row is blind to a shift
                # of its scores): both sides hold rounding alone, so it is
                # held against the query bias's gradient
                diff = (_whole(got_g[name]) - g).to(torch.float64)
                q = want_g[name.replace("wk/b", "wq/b")].to(torch.float64)
                gaps[f"grad {name}"] = (torch.linalg.vector_norm(diff)
                                        / torch.linalg.vector_norm(q)).item()

        # one decode step from a filled cache on the serving layouts
        if cfg.has_decode:
            gen = torch.Generator().manual_seed(1)
            state = model.init_decode_state(cfg, B, CACHE, start_pos=CACHE - 3, device="cpu")
            state = {k: v if k == "pos" else
                     (torch.randn(v.shape, generator=gen) * 0.5).to(v.dtype)
                     for k, v in state.items()}
            tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, dtype=torch.int32)
            want, want_s = model.decode_step(cfg, params, state, tokens)
            from repro_torch.distributed.sharding import P

            got, got_s = model.decode_step(
                cfg, put(params, inference_param_specs(cfg, mesh)),
                put(state, decode_state_specs(cfg, state, mesh)), put(tokens, P("data", None)))
            gaps["decode logits"] = _gap(_whole(got), want)
            for k, v in want_s.items():
                gaps[f"decode {k}"] = _gap(_whole(got_s[k]), v)
    return gaps


def _worker(rank: int, directory: str) -> None:
    out = {"rank": rank}
    dist.init_process_group("gloo", init_method=f"file://{directory}/rendezvous",
                            rank=rank, world_size=WORLD)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        torch.set_num_threads(1)        # four ranks share the host's cores
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
        from repro_torch.models import moe

        for name, make in CASES.items():
            t0 = time.perf_counter()
            moe.SERVING_TOKENS = 0 if name in TRAINING_LAYOUT else 4096
            out[name] = _case(make(), mesh)
            out[name]["seconds"] = time.perf_counter() - t0
    except BaseException as e:                      # reported to the test, then raised
        out["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        dist.destroy_process_group()
        with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case on the four ranks, spawned once for the file."""
    directory = str(tmp_path_factory.mktemp("mesh_values"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, directory)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        hung = any(p.is_alive() for p in procs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    out = []
    for r in range(WORLD):
        fn = os.path.join(directory, f"rank{r}.json")
        out.append(json.load(open(fn)) if os.path.exists(fn) else {"error": "no result"})
    assert not hung, f"a rank hung: {out}"
    errors = [r.get("error") for r in out if "error" in r]
    assert not errors, errors
    assert [p.exitcode for p in procs] == [0] * WORLD
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_results_hold_against_the_plain_path(case, results):
    for r in results:
        gaps = dict(r[case])
        gaps.pop("seconds")
        bad = {k: v for k, v in gaps.items() if v > TOL}
        assert not bad, f"rank {r['rank']}: {bad}"
        assert "loss" in gaps and any(k.startswith("grad ") for k in gaps)


def test_ranks_agree(results):
    """Every rank's whole results are the same numbers."""
    for case in CASES:
        first = dict(results[0][case])
        first.pop("seconds")
        for r in results[1:]:
            other = dict(r[case])
            other.pop("seconds")
            assert other == first, case


def test_no_process_group_outlives_this_file():
    assert not dist.is_initialized()
