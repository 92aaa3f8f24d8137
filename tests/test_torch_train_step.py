"""The port's optimizer and train step against the reference's on the
CPU, from one numpy train state (``tests/_train_common.py``,
``convert.train_state_from_numpy``): the learning-rate schedule,
``apply_updates`` on common gradients and moments, three steps of
``make_train_step`` at one and two microbatches, a checkpoint taken
before an in-place step, the checkpoint bytes of a trained state, and the
port's ``launch.train`` resuming a directory the reference's wrote.

Limits:

* ``lr_schedule``: within ``LR_REL`` (1e-6) of the reference's (the
  cosine differs in the last bit now and then); the control (a linear
  decay) differs by more than 1e-2;
* ``apply_updates`` on common inputs: each moment leaf within
  ``MOMENT_REL_UPDATE`` (1e-6) of its largest entry (the global norm sums
  in another order, so the clip scale differs in the last bit, and XLA
  fuses a multiply and an add into one rounding here and there), params
  within one bf16
  step of their own value on at most ``PARAM_SHARE`` (1%) of entries and
  equal elsewhere (a last-bit difference of the update lands a near-tie
  on the other side); these inputs read 0 ulps and 0%;
* three train steps: each step's loss within ``LOSS_REL`` (1e-4), its
  grad norm within ``GNORM_REL`` (1e-3), its learning rate within
  ``LR_REL``; after them each moment leaf within ``MOMENT_REL`` (5%) of
  its largest entry, and every param within twice the summed learning
  rates plus one bf16 step of its value of the reference's, on at most
  ``PARAM_SHARE_STEPS`` (10%) of entries and equal elsewhere.  The
  forward's bf16 flips reach the gradients, and Adam's first updates are
  about ``lr`` times the gradient's sign, so where a gradient entry is
  near 0 the two sides can step a weight in opposite directions; these
  read up to 1.5% (moments) and 6% of entries (params).  The control (the
  second moment's decay 0.9 in place of 0.95) goes over the moment limit;
* the resumed run's losses within ``RESUME_REL`` (1e-3) of the
  reference's printed ones (printed to 4 decimals, ~1e-5 of the loss);
  a fresh start in their place goes over it.
"""

import contextlib
import functools
import io
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _train_common import (LOSS_REL, grad_gaps, np_batch, np_train_state,  # noqa: F401
                           pinned_hash)
from repro.checkpoint import CheckpointConfig as RefCheckpointConfig
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.distributed.grad_sync import GradSync as RefGradSync
from repro.launch import train as ref_train
from repro.models import build_model
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import apply_updates as ref_apply_updates
from repro.optim import lr_schedule as ref_lr_schedule
from repro.train import make_train_step as ref_make_train_step
from repro_torch import _util, convert
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.distributed import GradSync, straggler_reissue_plan
from repro_torch.launch import train as port_train
from repro_torch.optim import AdamWConfig, apply_updates, lr_schedule
from repro_torch.train import init_train_state, make_train_step

LR_REL = 1e-6
MOMENT_REL_UPDATE = 1e-6
PARAM_SHARE = 1e-2
GNORM_REL = 1e-3
PARAM_SHARE_STEPS = 0.1
MOMENT_REL = 5e-2
RESUME_REL = 1e-3
ARCH = "repro_gpt_100m"
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bit for bit (bf16 as ml_dtypes' bfloat16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _f32(a):
    return _np(a).astype(np.float32) if isinstance(a, torch.Tensor) else \
        np.asarray(a).astype(np.float32)


def _bf16_steps(want, got):
    """Each entry's gap in bf16 steps of its own (reference) value."""
    want, got = _f32(want), _f32(got)
    exp = np.floor(np.log2(np.maximum(np.abs(want), np.finfo(np.float32).tiny)))
    return np.abs(want - got) / 2.0 ** (exp - 7)


# -------------------------------------------------------------------- schedule

def test_lr_schedule_matches_reference():
    """At step 0, warm-up - 1, warm-up, mid-decay, total and beyond."""
    ocfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    port, ref = AdamWConfig(**ocfg), RefAdamWConfig(**ocfg)
    for step in (0, 9, 10, 55, 100, 250):
        want = float(ref_lr_schedule(ref, jnp.asarray(step, jnp.int32)))
        got = lr_schedule(port, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= LR_REL * max(want, 1e-12), step
    assert float(lr_schedule(port, torch.tensor(0))) == 0.0
    assert float(lr_schedule(port, torch.tensor(250))) == pytest.approx(3e-5, rel=1e-6)


def test_lr_schedule_control_exceeds_the_limit():
    """A linear decay in place of the cosine differs a fifth into the decay."""
    port = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    t = (30 - 10) / 90
    linear = 3e-4 * (0.1 + 0.9 * (1 - t))
    got = float(lr_schedule(port, torch.tensor(30)))
    assert abs(linear - got) > 1e-2 * got


# ------------------------------------------------------------------- the update

def test_apply_updates_matches_reference():
    """One AdamW step on common params (bf16 matrices, a bf16 vector that
    takes no weight decay, an f32 matrix), gradients and moments, at step
    3 with clipping active."""
    rng = np.random.default_rng(0)
    bf = ml_dtypes.bfloat16
    params = {"w": (rng.standard_normal((64, 48)) * 0.05).astype(bf),
              "g": (1 + rng.standard_normal(48) * 0.01).astype(bf),
              "r": (rng.standard_normal((48, 8)) * 0.05).astype(np.float32)}
    grads = {k: (rng.standard_normal(v.shape) * 0.5).astype(v.dtype) for k, v in params.items()}
    m = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32) for k, v in params.items()}
    v = {k: (rng.random(v.shape) * 1e-3).astype(np.float32) for k, v in params.items()}
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    step = np.asarray(3, np.int32)
    want_p, want_o, want_m = ref_apply_updates(
        RefAdamWConfig(**ocfg), params, grads, {"m": m, "v": v}, jnp.asarray(step))
    to_t = lambda tree: convert.params_from_numpy(tree, "cpu")  # noqa: E731
    got_p, got_o, got_m = apply_updates(
        AdamWConfig(**ocfg), to_t(params), to_t(grads), {"m": to_t(m), "v": to_t(v)},
        torch.tensor(3, dtype=torch.int32))
    assert abs(float(got_m["grad_norm"]) - float(want_m["grad_norm"])) <= 1e-6 * float(
        want_m["grad_norm"])
    assert float(want_m["grad_norm"]) > 1.0             # clipping is active
    assert float(got_m["lr"]) == pytest.approx(float(want_m["lr"]), rel=LR_REL)
    for k in params:
        assert got_p[k].dtype == convert.params_from_numpy({"a": params[k]}, "cpu")["a"].dtype
        for part in ("m", "v"):
            want, got = np.asarray(want_o[part][k]), _f32(got_o[part][k])
            assert np.abs(want - got).max() <= MOMENT_REL_UPDATE * np.abs(want).max(), (part, k)
        if params[k].dtype == bf:
            steps = _bf16_steps(want_p[k], got_p[k])
            assert steps.max() <= 1 and (steps > 0).mean() <= PARAM_SHARE, k
        else:
            want = np.asarray(want_p[k])
            assert np.abs(want - _f32(got_p[k])).max() <= MOMENT_REL_UPDATE * np.abs(want).max()


def test_apply_updates_decays_only_matrices():
    """Weight decay moves a matrix with zero gradient, not a vector."""
    params = {"w": torch.ones((4, 4)), "b": torch.ones(4)}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    opt = {"m": {k: torch.zeros_like(v) for k, v in params.items()},
           "v": {k: torch.zeros_like(v) for k, v in params.items()}}
    ocfg = AdamWConfig(lr=1.0, warmup_steps=0, total_steps=10, weight_decay=0.1)
    p, _, _ = apply_updates(ocfg, params, grads, opt, torch.tensor(0, dtype=torch.int32))
    assert torch.equal(p["b"], torch.ones(4))
    assert torch.allclose(p["w"], torch.full((4, 4), 0.9))


# ------------------------------------------------------------------ train steps

def _ref_state(np_state):
    return jax.tree_util.tree_map(jnp.asarray, np_state)


@functools.lru_cache(maxsize=None)
def _ref_steps(microbatches, n=3):
    """The reference's (state, metrics) after each of ``n`` steps of the
    reduced repro_gpt_100m from the common numpy state."""
    jcfg = ref_get_config(ARCH).reduced()
    step = jax.jit(ref_make_train_step(build_model(jcfg), RefAdamWConfig(**OCFG),
                                       microbatches=microbatches))
    state = _ref_state(np_train_state(get_config(ARCH).reduced()))
    out = []
    for i in range(n):
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in _step_batch(i).items()})
        out.append((state, metrics))
    return out


def _step_batch(i):
    return np_batch(ARCH, step=i, seq=32, batch=4)


def _port_steps(microbatches, b2=0.95, n=3):
    """The port's (state, metrics) over the same ``n`` steps."""
    cfg = get_config(ARCH).reduced()
    step = make_train_step(cfg, AdamWConfig(b2=b2, **OCFG), microbatches=microbatches)
    state = convert.train_state_from_numpy(np_train_state(cfg), "cpu")
    out = []
    for i in range(n):
        state, metrics = step(state, convert.params_from_numpy(_step_batch(i), "cpu"))
        out.append(metrics)
    return state, out


def _moment_gaps(rs, ps):
    return [g for part in ("m", "v") for g in grad_gaps(
        jax.tree_util.tree_leaves(rs["opt"][part]), _util.tree_leaves(ps["opt"][part]))]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_reference(microbatches):
    """``make_train_step``: losses, grad norms, learning rates, then the
    params, moments and step after three steps."""
    ref = _ref_steps(microbatches)
    rs = ref[-1][0]
    ps, port = _port_steps(microbatches)
    metrics = [(rm, pm) for (_, rm), pm in zip(ref, port)]
    for rm, pm in metrics:
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= LOSS_REL * float(rm["loss"])
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= GNORM_REL * float(
            rm["grad_norm"])
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=LR_REL, abs=1e-12)
        if microbatches > 1:
            assert float(pm["aux"]) == 0.0 and float(pm["ce"]) == float(pm["loss"])
    assert ps["step"].dtype == torch.int32 and int(ps["step"]) == 3
    reach = 2 * sum(float(rm["lr"]) for rm, _ in metrics)
    for w, g in zip(jax.tree_util.tree_leaves(rs["params"]), _util.tree_leaves(ps["params"])):
        w, g = _f32(w), _f32(g)
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(w - g) <= reach + step).all()
        assert ((w != g).mean()) <= PARAM_SHARE_STEPS
    assert max(_moment_gaps(rs, ps)) <= MOMENT_REL
    assert not any(t.requires_grad or t.grad_fn is not None for t in _util.tree_leaves(ps))


def test_train_step_control_exceeds_the_limit():
    """The second moment's decay at 0.9 (the reference's is 0.95)."""
    ps, _ = _port_steps(1, b2=0.9)
    assert max(_moment_gaps(_ref_steps(1)[-1][0], ps)) > MOMENT_REL


def test_microbatches_accumulate_to_the_whole_batch():
    """Two microbatches give the whole batch's update within the
    reference's own tolerance for the same check (5e-2)."""
    cfg = get_config(ARCH).reduced()
    batch = convert.params_from_numpy(np_batch(ARCH, seq=32, batch=4), "cpu")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    a, _ = make_train_step(cfg, ocfg)(init_train_state(cfg, 1, device="cpu"), batch)
    b, _ = make_train_step(cfg, ocfg, microbatches=2)(init_train_state(cfg, 1, device="cpu"),
                                                      batch)
    for x, y in zip(_util.tree_leaves(a["params"]), _util.tree_leaves(b["params"])):
        torch.testing.assert_close(x.float(), y.float(), atol=5e-2, rtol=0)


# ------------------------------------------------------------------ checkpoints

def test_save_before_an_in_place_step_restores_the_pre_step_state(tmp_path):
    """The step updates params and moments in place; an async save taken
    before it still writes (and restores) the state as it was."""
    cfg = get_config(ARCH).reduced()
    state = init_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10))
    batch = convert.params_from_numpy(np_batch(ARCH, seq=32, batch=2), "cpu")
    state, _ = step(state, batch)
    before = _util.tree_map(torch.clone, state)
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), device="cpu"))
    mgr.save(1, state)                           # async: returns after the snapshot
    new, _ = step(state, batch)
    assert new["params"]["embed"]["table"] is state["params"]["embed"]["table"]
    assert not torch.equal(new["params"]["embed"]["table"], before["params"]["embed"]["table"])
    mgr.wait()
    _, back = mgr.restore(1)
    for (k, a), (_, b) in zip(_util.tree_flatten_with_keys(before),
                              _util.tree_flatten_with_keys(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def _trained_states(n=3):
    """The port's train state after each of ``n`` steps, as numpy trees."""
    cfg = get_config(ARCH).reduced()
    state = convert.train_state_from_numpy(np_train_state(cfg), "cpu")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    out = []
    for i in range(n):
        state, _ = step(state, convert.params_from_numpy(np_batch(ARCH, i, 32, 2), "cpu"))
        out.append(_util.tree_map(_np, state))
    return out


def test_train_state_checkpoints_equal_reference_bytes(tmp_path):
    """Saves of a trained state (a base, then a delta with the moments
    chained against the previous save, then a base) write the reference's
    bytes, and the port restores the last bit for bit."""
    states = _trained_states()
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port = CheckpointManager(CheckpointConfig(str(port_dir), base_every=2, device="cpu"))
    ref = RefCheckpointManager(RefCheckpointConfig(str(ref_dir), base_every=2))
    for i, s in enumerate(states, 1):
        port.save(i, convert.train_state_from_numpy(s, "cpu"), blocking=True)
        ref.save(i, s, blocking=True)
    kinds = {e["kind"] for e in __import__("json").load(
        open(port_dir / "step_2" / "manifest.json"))["entries"]}
    assert kinds == {"delta", "delta_prev"}
    for i in range(1, 4):
        for name in ("manifest.json", "data.bin"):
            assert (port_dir / f"step_{i}" / name).read_bytes() == \
                (ref_dir / f"step_{i}" / name).read_bytes(), (i, name)
    _, back = port.restore(2)
    for (k, a), (_, b) in zip(_util.tree_flatten_with_keys(states[1]),
                              _util.tree_flatten_with_keys(back)):
        assert np.asarray(a).tobytes() == _np(b).tobytes(), k


def _ref_main(argv):
    """The reference's ``launch.train.main`` in this process; its stdout."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["train"] + argv
    try:
        with contextlib.redirect_stdout(out):
            ref_train.main()
    finally:
        sys.argv = old
    return out.getvalue()


def _printed_losses(text):
    return {int(line.split()[1]): float(line.split("loss=")[1].split()[0])
            for line in text.splitlines() if line.startswith("step ")}


def test_launch_train_resumes_the_reference_directory(tmp_path):
    """The reference trains 4 steps and saves (base, delta); the port's
    ``launch.train`` resumes that directory at step 4 and runs steps 5-6;
    the reference resumes a copy of it: both print the same losses."""
    common = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "32", "--ckpt-every", "2",
              "--base-every", "2", "--log-every", "1", "--lr", "1e-3"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    _ref_main(common + ["--steps", "4", "--ckpt-dir", str(ref_dir)])
    shutil.copytree(ref_dir, port_dir)
    want = _printed_losses(_ref_main(common + ["--steps", "6", "--ckpt-dir", str(ref_dir)]))
    summary = port_train.main(common + ["--steps", "6", "--ckpt-dir", str(port_dir),
                                        "--device", "cpu"])
    assert summary["start"] == 4 and len(summary["losses"]) == 2
    assert sorted(want) == [5, 6]
    for step, got in zip((5, 6), summary["losses"]):
        assert abs(got - want[step]) <= RESUME_REL * want[step], (step, got, want[step])
    assert os.path.isdir(port_dir / "step_6")
    # control: a fresh start in the resumed run's place
    fresh = port_train.main(common + ["--steps", "2", "--device", "cpu"])
    assert abs(fresh["losses"][0] - want[5]) > RESUME_REL * want[5]


# ---------------------------------------------------------------------- GradSync

@pytest.fixture(scope="module")
def step_grads():
    """One reduced step's gradients, numpy (bf16 leaves)."""
    from _train_common import port_grads

    cfg = get_config(ARCH).reduced()
    params = convert.train_state_from_numpy(np_train_state(cfg), "cpu")["params"]
    batch = convert.params_from_numpy(np_batch(ARCH, 0, 32, 2), "cpu")
    _, _, grads = port_grads(cfg, params, batch)
    return _util.tree_unflatten(_util.tree_flatten(params)[1], [_np(g) for g in grads])


def test_grad_sync_manifest_equals_reference(step_grads):
    """Every leaf's blob, and the raw and compressed byte counts, equal the
    reference's; the round trip is bit-exact."""
    tgrads = convert.params_from_numpy(step_grads, "cpu")
    want, wst = RefGradSync().pack(step_grads)
    got, gst = GradSync(device="cpu").pack(tgrads)
    assert (got["raw_bytes"], got["comp_bytes"]) == (want["raw_bytes"], want["comp_bytes"])
    assert [c.blob for c in got["leaves"]] == [c.blob for c in want["leaves"]]
    assert gst.ratio_pct == wst.ratio_pct < 90.0
    back = GradSync(device="cpu").unpack(got)
    for a, b in zip(_util.tree_leaves(tgrads), _util.tree_leaves(back)):
        assert a.dtype == b.dtype and _np(a).tobytes() == _np(b).tobytes()


def test_grad_sync_exchange_equals_reference(step_grads):
    """``raw_s`` and ``ratio_pct`` of the ring model equal the reference's
    (``zipnn_s`` holds each side's measured compress time)."""
    tgrads = convert.params_from_numpy(step_grads, "cpu")
    want = RefGradSync().exchange(step_grads, n_peers=4, link_gbps=1.0)
    got = GradSync(device="cpu").exchange(tgrads, n_peers=4, link_gbps=1.0)
    assert got["raw_s"] == want["raw_s"] and got["ratio_pct"] == want["ratio_pct"]
    assert got["zipnn_s"] > 0


def test_grad_sync_exchange_raises_on_a_lossy_round_trip(step_grads, monkeypatch):
    """The integrity check is a raise (it stays under ``python -O``)."""
    tgrads = convert.params_from_numpy(step_grads, "cpu")
    gs = GradSync(device="cpu")
    real = gs.unpack

    def lossy(manifest):
        back = real(manifest)
        leaf = _util.tree_leaves(back)[0]
        leaf.view(torch.int16).view(-1)[0] ^= 1
        return back

    monkeypatch.setattr(gs, "unpack", lossy)
    with pytest.raises(IOError, match="lossy sync"):
        gs.exchange(tgrads, n_peers=4)


def test_straggler_plan():
    times = [1.0, 1.1, 0.9, 1.0, 5.0, 1.05, 9.0, 1.0]
    assert straggler_reissue_plan(times) == [4, 6]
