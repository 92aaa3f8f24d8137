"""repro-gpt-100m — the in-repo ~100 M-param LM (the same numbers as
``src/repro/configs/repro_gpt_100m.py``): 12 layers, d_model 768, 12 heads
of 64, d_ff 3072, vocab 32000, bf16."""

from .base import ModelConfig, register

register(ModelConfig(
    name="repro_gpt_100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=32000,
    head_dim=64,
    remat="none",
    source="in-repo",
))
