"""OLMoE-1B-7B — 64-expert top-8 MoE, 1 B active / 7 B total.
[arXiv:2409.02060; hf]"""

from .base import ModelConfig, register

register(ModelConfig(
    name="olmoe_1b_7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,               # per-expert FFN width
    vocab_size=50304,
    head_dim=128,
    moe=True,
    n_experts=64,
    experts_per_token=8,
    moe_d_ff=1024,
    zero3=True,
    source="arXiv:2409.02060",
))
