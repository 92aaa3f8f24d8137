"""The port's loss and every leaf's gradient against ``jax.grad`` of the
reference's ``Model.loss`` on the CPU, from one numpy state
(``tests/_train_common.py``), for the reduced configs of the attention
families: dense twice (the main path's repro_gpt_100m, and granite_20b:
layernorm, GELU, biases, learned positions, one KV head), MoE with MLA
(deepseek_v2_236b: shared experts, a dense first layer, pairs dropped at
the capacity factor 1.25) and vlm (qwen2_vl_2b: M-RoPE, the patch front
end, the plain CE on the text logits).  The reference runs jitted.

Limits (``_train_common``): the loss as in ``test_torch_train_loss.py``;
each leaf's largest gradient gap within ``GRAD_REL`` (5%) of its largest
reference entry, floored at ``GRAD_FLOOR`` (1%) of the largest entry of
any leaf.  Without rotary positions (granite, hubert) a key bias's
gradient is 0 in exact arithmetic (a constant added to a row of scores
leaves its softmax unchanged), so both sides hold rounding noise there:
each side's largest entry is held under ``ZERO_GRAD`` (1%) of the largest
entry of any leaf (these read up to 0.12%).  The bf16 flips of the forward reach every
gradient; these inputs read up to 2.4%.  The control (attention without
its causal mask) goes over it.
"""

import jax
import pytest

from _train_common import (GRAD_REL, check_grads, grad_gaps, pinned_hash,  # noqa: F401
                           port_grads, ref_value_and_grad, setup)
from repro_torch.models import attention


@pytest.mark.parametrize("arch", ["repro_gpt_100m", "granite_20b", "deepseek_v2_236b",
                                  "qwen2_vl_2b"])
def test_loss_and_gradients_match_jax_grad(arch):
    check_grads(arch)


def test_gradient_control_exceeds_the_limit(monkeypatch):
    """Attention without its causal mask: some leaf goes over the limit."""
    real = attention._attend
    monkeypatch.setattr(attention, "_attend",
                        lambda q, k, v, cfg, *, causal: real(q, k, v, cfg, causal=not causal))
    *_, cfg, params, batch = setup("repro_gpt_100m")
    _, want = ref_value_and_grad("repro_gpt_100m")
    _, _, got = port_grads(cfg, params, batch)
    assert max(grad_gaps(jax.tree_util.tree_leaves(want), got)) > GRAD_REL
