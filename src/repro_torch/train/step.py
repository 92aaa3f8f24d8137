"""The training step: loss, gradients by autograd, AdamW; with optional
microbatch accumulation.  A port of ``repro.train.step``.

A train state is ``{"params", "opt": {"m", "v"}, "step"}`` with a 0-d
int32 step, on one device.  The step function takes a state and a batch
and returns ``(state, metrics)``: gradients come from
``torch.autograd.grad`` over the param leaves, and :func:`apply_updates`
updates params and moments in place, so the returned state holds the
same tensors (and no autograd graph) with the step advanced.
:func:`train_state_specs` and :func:`batch_pspecs` give the state's and a
batch's sharding specs (``repro_torch.distributed.sharding``), for
``CheckpointManager.shard_restore`` and ``device_put_tree``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from .. import _util
from ..distributed.sharding import P, batch_pspec, laid_out_like
from ..models import model
from ..optim.adamw import AdamWConfig, apply_updates, init_opt_state

__all__ = [
    "TrainState",
    "init_train_state",
    "train_state_specs",
    "batch_pspecs",
    "loss_and_grads",
    "make_train_step",
]

TrainState = Dict[str, Any]      # {"params": ..., "opt": {"m", "v"}, "step": int32}


def init_train_state(cfg, seed: int = 0, *, device: Any = "cuda") -> TrainState:
    """Fresh state on ``device``: :func:`~repro_torch.models.model.init_params`
    of ``seed`` with the norms' gains 1 and biases 0 (as the reference's
    ``Model.init`` makes them), zero moments, step 0."""
    dev = _util.resolve_device(device)
    params = model.reference_norms(model.init_params(cfg, seed, device=dev))
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_state_specs(cfg, mesh=None) -> TrainState:
    """Specs for the whole train state: the params' (``model.param_specs``),
    the moments mirroring them, the step replicated."""
    pspecs = model.param_specs(cfg, mesh)
    return {"params": pspecs, "opt": {"m": pspecs, "v": pspecs}, "step": P()}


def batch_pspecs(batch_tree: Any, mesh=None) -> Any:
    """Each batch leaf's spec: its leading axis over the batch axes of
    ``mesh`` (``("pod", "data")`` as far as the mesh has them), the rest
    replicated."""
    bp = batch_pspec(mesh)
    return _util.tree_map(lambda leaf: P(*(list(bp) + [None] * (leaf.ndim - 1))), batch_tree)


def loss_and_grads(cfg, params, batch):
    """``(loss, metrics, grads)``: the loss and its gradient for every
    param leaf (in the leaf's dtype and, on a mesh, its layout; zeros for a
    leaf the loss does not read, such as the audio family's token table),
    with no graph kept."""
    leaves, treedef = _util.tree_flatten(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    total, metrics = model.loss(cfg, _util.tree_unflatten(treedef, xs), batch)
    grads = torch.autograd.grad(total, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else laid_out_like(g, x) for x, g in zip(xs, grads)]
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            _util.tree_unflatten(treedef, grads))


def make_train_step(
    cfg, ocfg: AdamWConfig, *, microbatches: int = 1,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, Any]]]:
    """The step function for ``cfg`` under ``ocfg``.

    ``microbatches > 1`` splits every batch tensor on axis 0 into that many
    parts, runs them in order and accumulates ``loss / M`` and the
    gradients ``g.f32 / M`` in f32 from 0, as the reference's scan does;
    its metrics are then ``{"ce": loss, "aux": 0}``.  Metrics are 0-d
    tensors: ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``.
    """

    def accumulated(params, batch):
        parts = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
                 for k, v in batch.items()}
        dev = _util.tree_leaves(params)[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in _util.tree_leaves(params)]
        for i in range(microbatches):
            li, _, gi = loss_and_grads(cfg, params, {k: v[i] for k, v in parts.items()})
            loss = loss + li / microbatches
            acc = [a + g.to(torch.float32) / microbatches
                   for a, g in zip(acc, _util.tree_leaves(gi))]
        grads = _util.tree_unflatten(_util.tree_flatten(params)[1], acc)
        return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=dev)}, grads

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        if microbatches > 1:
            loss, metrics, grads = accumulated(params, batch)
        else:
            loss, metrics, grads = loss_and_grads(cfg, params, batch)
        new_params, new_opt, om = apply_updates(ocfg, params, grads, state["opt"], state["step"])
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return new_state, metrics

    return step_fn
