"""H2O-Danube-3-4B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""

from .base import ModelConfig, register

register(ModelConfig(
    name="h2o_danube3_4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,            # GQA kv=8
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    window=8192,             # mistral-style SWA ⇒ sub-quadratic, runs long_500k
    rope_theta=1e4,
    zero3=True,
    source="arXiv:2401.16818",
))
