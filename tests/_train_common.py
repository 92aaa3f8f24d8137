"""Shared set-up of the training slice's CPU tests: one numpy train state
and one batch from which both packages start, the reference's jitted
loss and gradient (cached per config in the process), the port's, and the
gradient comparison.

The params are drawn with numpy in the reference's layout (the port's
``param_shapes``, which equals it) the way the reference's ``Model.init``
scales them: weights, embeddings and heads N(0, 1) / sqrt(shape[-2]) (its
``_he``), learned positions 0.02 N(0, 1), norm gains 1 and biases 0, the Mamba2
conv 0.1 N(0, 1), ``A_log = log(linspace(1, 16, H))``, ``D = 1``,
``dt_bias = 0``; the MoE routers and the Mamba2 ``ssm`` leaves f32, the
rest in the config's dtype.  (The reference's own ``init`` draws the
same distribution from JAX's generator and takes seconds a config
eagerly.)  The batch is the reference's ``make_batch`` with its seed's
``hash(cfg.name)`` pinned to the name's CRC-32.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import DataConfig as RefDataConfig
from repro.data import make_batch as ref_make_batch
from repro.data import pipeline as ref_pipeline
from repro.models import build_model
from repro_torch import _util, convert
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.models import model

SEQ, BATCH = 64, 2
LOSS_REL = 1e-4
AUX_REL = 5e-3
GRAD_REL = 5e-2
GRAD_FLOOR = 1e-2
ZERO_GRAD = 1e-2


def _crc_hash(name):
    return zlib.crc32(name.encode())


@pytest.fixture(autouse=True)
def pinned_hash():
    """``hash(cfg.name)`` in both pipelines' seeds pinned to the CRC-32 of
    the name (Python salts ``hash`` of a ``str`` per process)."""
    for m in (pipeline, ref_pipeline):
        m.hash = _crc_hash
    try:
        yield
    finally:
        for m in (pipeline, ref_pipeline):
            del m.hash


def np_params(cfg, seed=0):
    """The numpy param tree of ``cfg`` (module docstring)."""
    rng = np.random.default_rng(seed)
    dtypes = model.param_dtypes(cfg)

    def draw(shape, path, dt):
        npdt = np.float32 if dt == torch.float32 else np.dtype(ml_dtypes.bfloat16)
        name = path[-1]
        if path[-2].endswith("norm"):
            a = np.ones(shape) if name == "g" else np.zeros(shape)
        elif path[-2] == "ssm":
            H = shape[-1]
            a = {"A_log": np.broadcast_to(np.log(np.linspace(1.0, 16.0, H)), shape),
                 "D": np.ones(shape), "dt_bias": np.zeros(shape)}[name]
        elif name == "b" or name.startswith("b_"):
            a = np.zeros(shape)
        elif path[-2] == "conv":
            a = rng.standard_normal(shape) * 0.1
        elif path[0] == "pos":
            a = rng.standard_normal(shape) * 0.02
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return np.ascontiguousarray(a).astype(npdt)

    def walk(node, dt, path):
        if isinstance(node, dict):
            return {k: walk(node[k], dt[k], path + (k,)) for k in node}
        return draw(node, path, dt)

    return walk(model.param_shapes(cfg), dtypes, ())


def np_train_state(cfg, seed=0, step=0):
    """``{"params", "opt": {"m", "v"}, "step"}`` of numpy arrays: the params
    of :func:`np_params`, zero f32 moments."""
    params = np_params(cfg, seed)
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), params)
    return {"params": params, "opt": {"m": zeros, "v": jax.tree_util.tree_map(np.copy, zeros)},
            "step": np.asarray(step, np.int32)}


def np_batch(arch, step=0, seq=SEQ, batch=BATCH):
    jcfg = ref_get_config(arch).reduced()
    return {k: np.asarray(v) for k, v in
            ref_make_batch(jcfg, RefDataConfig(seq_len=seq, global_batch=batch), step).items()}


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(reference model, jnp params, jnp batch, port config, port params,
    port batch) of ``arch``'s reduced config: both from one numpy state."""
    jcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    state = convert.train_state_from_numpy(np_train_state(cfg), "cpu")
    nb = np_batch(arch)
    return (build_model(jcfg), jax.tree_util.tree_map(jnp.asarray, np_params(cfg)),
            {k: jnp.asarray(v) for k, v in nb.items()}, cfg, state["params"],
            convert.params_from_numpy(nb, "cpu"))


@functools.lru_cache(maxsize=None)
def ref_value_and_grad(arch):
    """The reference's ``((total, {"ce", "aux"}), grads)`` of ``arch``, jitted."""
    ref, params, batch, *_ = setup(arch)
    return jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(params, batch)


def port_grads(cfg, params, batch):
    """(total, {"ce", "aux"}, gradient a leaf) of the port's loss."""
    leaves, treedef = _util.tree_flatten(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    total, metrics = model.loss(cfg, _util.tree_unflatten(treedef, xs), batch)
    grads = torch.autograd.grad(total, xs, allow_unused=True)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)])


def grad_gaps(want_leaves, got_leaves, zero=()):
    """Each leaf's largest gap over its largest reference entry, floored at
    ``GRAD_FLOOR`` of the largest entry of any leaf.  The leaves whose
    indices are in ``zero`` have gradient 0 in exact arithmetic, so both
    sides hold rounding noise there: their reading is the larger of the
    two sides' largest entries over ``ZERO_GRAD`` of the largest entry of
    any leaf, scaled so that ``GRAD_REL`` is the limit again."""
    want = [np.asarray(w).astype(np.float32) for w in want_leaves]
    top = max(np.abs(w).max() for w in want)
    out = []
    for i, (w, g) in enumerate(zip(want, got_leaves)):
        g = g.float().numpy()
        assert g.shape == w.shape
        if i in zero:
            out.append(max(np.abs(w).max(), np.abs(g).max()) / (ZERO_GRAD * top) * GRAD_REL)
        else:
            out.append(np.abs(w - g).max() / max(np.abs(w).max(), GRAD_FLOOR * top))
    return out


def check_loss(want_total, want, total, got):
    """The port's loss against the reference's, within the limits."""
    for k in ("ce", "aux"):
        assert got[k].dtype == torch.float32 and got[k].shape == ()
    assert abs(float(got["ce"]) - float(want["ce"])) <= LOSS_REL * abs(float(want["ce"]))
    assert abs(float(got["aux"]) - float(want["aux"])) <= AUX_REL * max(abs(float(want["aux"])),
                                                                        1e-6)
    assert abs(float(total) - float(want_total)) <= LOSS_REL * abs(float(want_total))


def check_grads(arch):
    """The port's loss and every leaf's gradient against ``jax.grad``."""
    *_, cfg, params, batch = setup(arch)
    (want_total, want), want_grads = ref_value_and_grad(arch)
    total, got, grads = port_grads(cfg, params, batch)
    check_loss(want_total, want, total, got)
    keys, leaves = zip(*_util.tree_flatten_with_keys(params))
    for k, p, g in zip(keys, leaves, grads):
        assert g.dtype == p.dtype and g.shape == p.shape, k
    # Without rotary positions a key bias adds one constant to each row of
    # scores, which its softmax ignores: its gradient is 0 but for rounding.
    zero = () if cfg.use_rope or cfg.mrope else {
        i for i, k in enumerate(keys) if k.endswith("wk/b")}
    gaps = grad_gaps(jax.tree_util.tree_leaves(want_grads), grads, zero)
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    assert gaps[worst] <= GRAD_REL, (keys[worst], gaps[worst])
