"""Granite-20B-Code — gpt_bigcode arch: MQA (kv=1), layernorm+gelu, learned
positions. [arXiv:2405.04324; hf]"""

from .base import ModelConfig, register

register(ModelConfig(
    name="granite_20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,            # MQA
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    use_rope=False,
    pos_embedding="learned",
    max_position=32768,
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    zero3=True,              # 20B params: shard optimizer+params over data
    source="arXiv:2405.04324",
))
