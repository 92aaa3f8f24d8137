"""The port's training loss against the reference's ``Model.loss`` on
the CPU, for the reduced configs whose gradients the ``test_torch_train
_grads*`` files do not hold (those files hold the loss of the rest), and
activation checkpointing (``remat``), which changes memory and never a
value.  Both packages start from one numpy state
(``tests/_train_common.py``); the reference runs jitted.

Limits (``_train_common``): ``ce`` and the total within ``LOSS_REL``
(1e-4) of the reference's, ``aux`` (the MoE load-balance loss) within
``AUX_REL`` (5e-3).  The forwards round at the same points but XLA's f32
``exp``, dot and reduce orders differ from PyTorch's in the last bit, so a
bf16 activation now and then rounds to the other neighbour; these inputs
read up to 4e-5 of the loss.  ``aux`` counts each token's top-1 expert,
so where such a flip moves a near-tie between two experts it moves by a
whole token's share: olmoe's reads 1.8e-3 (one of 128 tokens in its
second layer), deepseek's 2e-5.  The control (attention without its causal mask) moves
the loss by more than ``CONTROL_LOSS_REL`` (1e-3).
"""

import dataclasses

import jax
import pytest
import torch

from _train_common import check_loss, pinned_hash, port_grads, setup  # noqa: F401
from repro_torch.models import attention, blocks, model

CONTROL_LOSS_REL = 1e-3
LOSS_ARCHS = ["h2o_danube3_4b", "yi_6b", "qwen15_4b", "olmoe_1b_7b"]


def _ref_loss(arch):
    ref, params, batch, *_ = setup(arch)
    return jax.jit(ref.loss)(params, batch)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_matches_reference(arch):
    """``model.loss`` (fused CE on the trunk) against ``Model.loss``:
    ``ce``, ``aux`` and the total."""
    *_, cfg, params, batch = setup(arch)
    want_total, want = _ref_loss(arch)
    with torch.no_grad():
        total, got = model.loss(cfg, params, batch)
    check_loss(want_total, want, total, got)


def test_loss_control_exceeds_the_limit(monkeypatch):
    """Without the causal mask the loss moves by far more than the limit."""
    real = attention._attend
    monkeypatch.setattr(attention, "_attend",
                        lambda q, k, v, cfg, *, causal: real(q, k, v, cfg, causal=not causal))
    *_, cfg, params, batch = setup("h2o_danube3_4b")
    want_total, _ = _ref_loss("h2o_danube3_4b")
    with torch.no_grad():
        total, _ = model.loss(cfg, params, batch)
    assert abs(float(total) - float(want_total)) > CONTROL_LOSS_REL * abs(float(want_total))


@pytest.mark.parametrize("arch, remat", [("repro_gpt_100m", "full"), ("repro_gpt_100m", "dots"),
                                         ("olmoe_1b_7b", "full"), ("zamba2_7b", "full")])
def test_remat_changes_no_gradient(arch, remat):
    """Activation checkpointing around each layer (``"full"``, and
    ``"dots"``, which keeps the matmul outputs) gives the gradients of
    ``"none"`` bit for bit, through the custom backward passes it
    recomputes (flash, combine, dispatch, the fused CE outside it)."""
    *_, cfg, params, batch = setup(arch)
    _, _, plain = port_grads(dataclasses.replace(cfg, remat="none"), params, batch)
    _, _, got = port_grads(dataclasses.replace(cfg, remat=remat), params, batch)
    for a, b in zip(plain, got):
        assert torch.equal(a, b)


def test_remat_dots_keeps_no_score_block():
    """Under ``"dots"`` the checkpoint keeps the projections' outputs, never
    a product run inside the flash loop's forward (its (q_block, kv_block)
    score blocks), which would make a layer's saved memory grow as S^2."""
    from torch.utils import checkpoint as ckpt

    *_, cfg, params, batch = setup("repro_gpt_100m")
    cfg = dataclasses.replace(cfg, remat="dots")
    kept = []
    real = ckpt._CachingTorchDispatchMode.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        out = real(self, func, types, args, kwargs)
        if self.storage[ckpt._sac_storage_key(func, args)][
                self.func_counter[ckpt._sac_storage_key(func, args)] - 1] is not ckpt._RECOMPUTE:
            kept.append(tuple(out.shape))
        return out

    ckpt._CachingTorchDispatchMode.__torch_dispatch__ = spy
    try:
        port_grads(cfg, params, batch)
    finally:
        ckpt._CachingTorchDispatchMode.__torch_dispatch__ = real
    B, S = batch["tokens"].shape
    assert kept and all(shape[0] == B * S for shape in kept)


def test_remat_full_recomputes_each_layer(monkeypatch):
    """Under ``"full"`` each layer's block runs twice (the forward, then
    again in the backward); under ``"none"`` once."""
    calls = []
    real = blocks.dense_block_train
    monkeypatch.setattr(blocks, "dense_block_train",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    *_, cfg, params, batch = setup("repro_gpt_100m")
    for remat, want in (("none", cfg.n_layers), ("full", 2 * cfg.n_layers)):
        calls.clear()
        port_grads(dataclasses.replace(cfg, remat=remat), params, batch)
        assert len(calls) == want, remat


def test_stack_gradient_is_stacked_once(monkeypatch):
    """The layer loop splits each stacked leaf once (``unbind``), so its
    gradient is one stack of the layers' gradients, not the sum of a
    zero-padded full-stack tensor a layer."""
    selects = []
    real = torch.Tensor.__getitem__

    def spy(self, idx):
        if isinstance(idx, int) and self.requires_grad:
            selects.append(idx)
        return real(self, idx)

    *_, cfg, params, batch = setup("repro_gpt_100m")
    monkeypatch.setattr(torch.Tensor, "__getitem__", spy)
    port_grads(cfg, params, batch)
    assert selects == []
