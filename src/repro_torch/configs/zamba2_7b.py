"""Zamba2-7B — Mamba2 backbone + shared attention block every 6 layers.
The shared block uses a 4096-token sliding window so the 500 k decode cell
keeps a bounded cache (the reference's deviation from the published model).
[arXiv:2411.15242; unverified]"""

from .base import ModelConfig, register

register(ModelConfig(
    name="zamba2_7b",
    family="hybrid",
    n_layers=81,             # mamba2 layers; shared attn applied every 6
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,              # shared block FFN
    vocab_size=32000,
    head_dim=112,
    window=4096,             # shared attn sliding window (bounded 500k cache)
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    zero3=True,
    source="arXiv:2411.15242",
))
