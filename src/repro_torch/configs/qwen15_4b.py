"""Qwen1.5-4B — llama-like with QKV bias, MHA (kv == heads).
[hf:Qwen/Qwen1.5-4B; hf]"""

from .base import ModelConfig, register

register(ModelConfig(
    name="qwen15_4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,           # full MHA
    d_ff=6912,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=5e6,
    zero3=True,
    source="hf:Qwen/Qwen1.5-4B",
))
