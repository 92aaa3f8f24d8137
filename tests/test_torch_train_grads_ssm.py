"""The port's loss and every leaf's gradient against ``jax.grad`` of the
reference's ``Model.loss`` on the CPU, from one numpy state
(``tests/_train_common.py``), for the reduced configs of the SSM
(mamba2_130m: the chunked SSD scan and causal convolution by plain
autograd, ``-inf`` masked before the ``exp``), hybrid (zamba2_7b: Mamba2
groups and the shared attention block) and audio (hubert_xlarge:
encoder-only, f32 params, learned positions, the frame front end)
families.  Limits and their readings as in ``test_torch_train_grads.py``
(up to 2.4%, the hybrid's token table).  The control (the SSD scan
without its ``D * x`` skip) goes over them.
"""

import jax
import numpy as np
import pytest
import torch

from _train_common import (GRAD_REL, check_grads, grad_gaps, pinned_hash,  # noqa: F401
                           port_grads, ref_value_and_grad, setup)
from repro_torch.models import ssm


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_7b", "hubert_xlarge"])
def test_loss_and_gradients_match_jax_grad(arch):
    check_grads(arch)


def test_ssm_gradient_control_exceeds_the_limit(monkeypatch):
    """The SSD scan without its ``D * x`` skip: some leaf goes over."""
    real = ssm.ssd_scan
    monkeypatch.setattr(ssm, "ssd_scan", lambda xh, dt, A, Bc, Cc, D, chunk:
                        real(xh, dt, A, Bc, Cc, torch.zeros_like(D), chunk))
    *_, cfg, params, batch = setup("mamba2_130m")
    _, want = ref_value_and_grad("mamba2_130m")
    _, _, got = port_grads(cfg, params, batch)
    assert max(grad_gaps(jax.tree_util.tree_leaves(want), got)) > GRAD_REL


def test_ssd_scan_gradients_are_finite_past_the_mask():
    """The scan's masked segment sums are ``-inf`` before the ``exp``, so
    no ``inf * 0`` reaches the backward: every gradient is finite, at a
    sequence padded to its chunk, with a decay strong enough that the
    unmasked upper triangle would overflow."""
    rng = np.random.default_rng(0)
    B, S, H, P, N, Q = 1, 40, 2, 4, 8, 16
    xh = torch.tensor(rng.standard_normal((B, S, H, P)), dtype=torch.bfloat16, requires_grad=True)
    dt = torch.tensor(rng.random((B, S, H)) * 8, dtype=torch.float32, requires_grad=True)
    A = torch.tensor([-10.0, -20.0], requires_grad=True)
    Bc = torch.tensor(rng.standard_normal((B, S, N)), dtype=torch.bfloat16, requires_grad=True)
    Cc = torch.tensor(rng.standard_normal((B, S, N)), dtype=torch.bfloat16, requires_grad=True)
    D = torch.ones(H, requires_grad=True)
    y = ssm.ssd_scan(xh, dt, A, Bc, Cc, D, Q)
    grads = torch.autograd.grad(y.float().sum(), [xh, dt, A, Bc, Cc, D])
    assert all(torch.isfinite(g.float()).all() for g in grads)
