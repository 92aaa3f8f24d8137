"""HuBERT-XLarge — encoder-only audio transformer (w2v2 arch), masked
cluster prediction over 504 codes; conv frontend stubbed to precomputed
frame embeddings. [arXiv:2106.07447; unverified]"""

from .base import ModelConfig, register

register(ModelConfig(
    name="hubert_xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,          # k-means cluster codes
    head_dim=80,
    encoder_only=True,       # no decode shapes (DESIGN.md §4)
    use_rope=False,
    pos_embedding="learned",
    max_position=32768,
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    param_dtype="float32",   # published weights are FP32 → ZipNN FP32 path
    frontend="audio",
    frontend_dim=512,        # conv feature extractor output (stub)
    zero3=True,
    source="arXiv:2106.07447",
))
