"""Qwen2-VL-2B backbone — M-RoPE, dynamic-resolution vision (frontend is a
stub providing precomputed patch embeddings). [arXiv:2409.12191; hf]"""

from .base import ModelConfig, register

register(ModelConfig(
    name="qwen2_vl_2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,            # GQA kv=2
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),   # freq pairs for (t, h, w); sums to hd/2
    rope_theta=1e6,
    frontend="vision",
    frontend_dim=1176,       # 14×14 patch × 2×2 merge × 1.5 ch (stub dim)
    zero3=True,
    source="arXiv:2409.12191",
))
