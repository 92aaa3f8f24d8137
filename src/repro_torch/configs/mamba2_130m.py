"""Mamba2-130M — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""

from .base import ModelConfig, register

register(ModelConfig(
    name="mamba2_130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,               # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=0,
    use_rope=False,
    pos_embedding="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    sp=False,                # 130M: residuals are small; skip the SP gathers
    source="arXiv:2405.21060",
))
