"""Yi-6B — llama-arch GQA. [arXiv:2403.04652; hf]"""

from .base import ModelConfig, register

register(ModelConfig(
    name="yi_6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,            # GQA kv=4
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5e6,
    zero3=True,
    source="arXiv:2403.04652",
))
