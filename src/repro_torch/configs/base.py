"""ModelConfig dataclass, the architecture registry and the shape cells.

Field for field the reference's ``repro.configs.base.ModelConfig``, so a
config module registers the same published numbers in both packages;
``dtype`` is a ``torch.dtype``.  ``reduced()`` derives the
family-preserving small config the CPU tests use.  ``param_count`` /
``active_param_count`` count the port's own ``param_shapes`` (the
reference counts its ``Model.abstract_params()``: the same tree).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 ⇒ d_model // n_heads

    # attention
    window: int = 0                # sliding-window size (0 = full attention)
    qkv_bias: bool = False
    rope_theta: float = 1e4
    use_rope: bool = True
    pos_embedding: str = "rope"    # rope | learned | none
    max_position: int = 32768      # learned-pos table length
    encoder_only: bool = False
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    q_block: int = 512
    kv_block: int = 1024

    # MLA (DeepSeek-V2)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0
    aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25
    dispatch_shards: int = 1

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssd_chunk: int = 128
    shared_attn_every: int = 0

    # modality frontend
    frontend: str = "none"         # none | vision | audio
    frontend_dim: int = 0

    # numerics / structure
    ce_chunks: int = 8
    param_dtype: str = "bfloat16"
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # distribution (kept for field parity; single-device here)
    zero3: bool = False
    sp: bool = True
    remat: str = "full"
    scan_layers: bool = True
    attn_impl: str = "flash"

    # provenance
    source: str = ""

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """May run the long_500k cell (sub-quadratic context handling)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for 6·N·D."""
        from ..models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from ..models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests (the same
        numbers as the reference's ``reduced()``)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.family == "hybrid" else 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32,
            d_ff=256 if not self.moe else self.d_ff,
            dense_d_ff=256,
            vocab_size=512,
            max_position=512,
            window=min(self.window, 64) if self.window else 0,
            q_block=64,
            kv_block=64,
            n_experts=8 if self.moe else 0,
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.moe else 0,
            q_lora_rank=32 if self.mla else 0,
            kv_lora_rank=16 if self.mla else 0,
            qk_nope_dim=32 if self.mla else 128,
            qk_rope_dim=16 if self.mla else 64,
            v_head_dim=32 if self.mla else 128,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32,
            ssd_chunk=32,
            shared_attn_every=2 if self.shared_attn_every else 0,
            frontend_dim=64 if self.frontend != "none" else 0,
            zero3=False,
            remat="none",
        )


# ---------------------------------------------------------------------------
# Shape cells (assigned): seq_len × global_batch per kind
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


ARCHS = [
    "h2o_danube3_4b",
    "granite_20b",
    "yi_6b",
    "qwen15_4b",
    "qwen2_vl_2b",
    "olmoe_1b_7b",
    "deepseek_v2_236b",
    "mamba2_130m",
    "hubert_xlarge",
    "zamba2_7b",
]

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    return list(ARCHS)


def shape_cells(cfg: ModelConfig) -> List[ShapeCell]:
    """The cells an arch runs: train and prefill for every arch, decode
    where it has a decode path, and the long cell where it is also
    sub-quadratic."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"]]
    if cfg.has_decode:
        cells.append(SHAPES["decode_32k"])
        if cfg.subquadratic:
            cells.append(SHAPES["long_500k"])
    return cells
