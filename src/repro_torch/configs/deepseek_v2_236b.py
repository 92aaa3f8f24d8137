"""DeepSeek-V2-236B — MLA (kv_lora=512) + 2 shared / 160 routed top-6 MoE.
236 B total, ~21 B active. [arXiv:2405.04434; hf]"""

from .base import ModelConfig, register

register(ModelConfig(
    name="deepseek_v2_236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # nominal; MLA replaces the KV path
    d_ff=1536,               # per routed expert
    vocab_size=102400,
    head_dim=128,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=160,
    n_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1536,
    first_k_dense=1,         # layer 0 is a dense FFN
    dense_d_ff=12288,
    zero3=True,              # mandatory at 236 B
    source="arXiv:2405.04434",
))
