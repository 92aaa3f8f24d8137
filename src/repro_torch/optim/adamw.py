"""AdamW with fp32 moments, global-norm clipping and a warm-up + cosine
schedule: a port of ``repro.optim.adamw``.

The moments ``m`` and ``v`` are f32 trees mirroring the parameters.  The
Adam epsilon (1e-8, about 2^-27) is the noise floor the paper (§3.1)
finds bounding the moments' exponent range from below, which is what
makes optimizer state compress.  The checkpoint manager stores the
moments as XOR deltas against the *previous save* (not the periodic
base): moments are EMAs, so step-over-step deltas are far sparser than
weight deltas; it finds them by :data:`MOMENT_KEYS`.

Every scalar of the update (the learning rate, ``b1 ** t``, the cosine,
the clip scale) is an f32 tensor on the parameters' device, as the
reference's jitted update computes it; the step reads nothing back to the
host.  :func:`apply_updates` updates params and moments in place under
``torch.no_grad()``: a state saved before the step is safe only because
``CheckpointManager.save`` snapshots it before it returns.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from .. import _util

__all__ = ["MOMENT_KEYS", "is_moment_path", "AdamWConfig", "lr_schedule",
           "init_opt_state", "apply_updates"]

PyTree = Any

# Top-level keys of :func:`init_opt_state`'s tree.
MOMENT_KEYS: Tuple[str, ...] = ("m", "v")


def is_moment_path(key: str, moment_keys: Tuple[str, ...] = MOMENT_KEYS) -> bool:
    """True when a flat checkpoint key addresses an optimizer moment.

    Matches ``m/...`` / ``v/...`` (an optimizer state saved alone) and
    ``<anything>/m/...`` one level down (the train-state layout
    ``opt/m/...``); a *parameter* named ``m`` deeper in the tree never
    matches.
    """
    parts = key.split("/")
    return bool(parts) and (
        parts[0] in moment_keys or (len(parts) > 1 and parts[1] in moment_keys)
    )


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_frac * lr`` at ``total_steps``, flat after: an f32 tensor on
    ``step``'s device."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: PyTree) -> Dict[str, PyTree]:
    """Zero f32 moments ``{"m", "v"}`` mirroring ``params``, on their devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": _util.tree_map(zeros, params), "v": _util.tree_map(zeros, params)}


def _global_norm(leaves) -> torch.Tensor:
    """``sqrt(sum of each leaf's f32 sum of squares)``."""
    return torch.sqrt(torch.stack([(g.to(torch.float32) ** 2).sum() for g in leaves]).sum())


def apply_updates(
    cfg: AdamWConfig, params: PyTree, grads: PyTree, opt_state: Dict[str, PyTree],
    step: torch.Tensor,
) -> Tuple[PyTree, Dict[str, PyTree], Dict[str, torch.Tensor]]:
    """One AdamW step at ``step`` (0-d int): ``(params, opt_state,
    {"grad_norm", "lr"})``.

    Gradients are clipped to ``grad_clip`` by their global norm; weight
    decay applies to leaves with ``ndim >= 2`` only; each parameter is
    rounded once, ``(p.f32 - lr * delta).to(p.dtype)``.  Params and
    moments are updated in place and returned in the same trees.
    """
    flat_p, treedef = _util.tree_flatten(params)
    flat_g = _util.tree_leaves(grads)
    flat_m = _util.tree_leaves(opt_state["m"])
    flat_v = _util.tree_leaves(opt_state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments must have the same leaves")
    b1, b2 = cfg.b1, cfg.b2
    with torch.no_grad():
        gnorm = _global_norm(flat_g)
        scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
        lr = lr_schedule(cfg, step)
        t = step.to(torch.float32) + 1.0
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            gf = g.to(torch.float32) * scale
            m.copy_(b1 * m + (1 - b1) * gf)
            v.copy_(b2 * v + (1 - b2) * gf * gf)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if p.dim() >= 2:
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
