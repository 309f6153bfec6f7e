"""Architecture / shape / SALR configuration dataclasses and registry.

The port's own copy of ``repro.configs.base`` (the port imports nothing
of the reference package).  Only the fields of the dense, MoE and MLA
decoders served so far are live; the rest are kept so the copy stays
field-for-field equal to the reference (a CPU test pins that).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SALRModelConfig:
    """How SALR is applied across a model's linear layers."""
    enabled: bool = True
    sparsity: float = 0.5
    method: str = "bitmap"          # dense | mask | bitmap | nm | bitmap_nf4
    lora_rank: int = 64
    res_rank: int = 64
    targets: tuple = ("attn", "mlp", "expert", "recurrent")
    # default linear route of the execution plan: "kernel" runs the CUDA
    # SpMM kernels, "reference" decodes the base dense and runs a GEMM
    backend: str = "kernel"
    dual_repr: bool = False
    decode_repr: Optional[str] = None
    budget: Optional[object] = None   # BudgetConfig: not yet ported


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    """``pattern`` of block kinds, repeated ``repeats`` times."""
    pattern: tuple
    repeats: int
    mlp: Optional[str] = None        # override ArchConfig.mlp for this group

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_groups: tuple              # decoder (or only) stack
    head_dim: Optional[int] = None
    mlp: str = "swiglu"              # swiglu | relu2 | gelu | none
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_drop_threshold: float = 0.0
    first_dense_layers: int = 0
    mla: Optional[MLAConfig] = None
    window: int = 0
    rope_theta: float = 1e4
    rnn_width: int = 0
    conv_width: int = 4
    encoder_groups: tuple = ()
    frontend: Optional[str] = None
    frontend_len: int = 0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    kv_cache: str = "native"
    decode_kv_cache: Optional[str] = None
    salr: SALRModelConfig = SALRModelConfig()
    sub_quadratic: bool = False

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.layer_groups)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def decode_prefix_len(self) -> int:
        return (self.frontend_len
                if self.frontend and self.family != "encdec" else 0)

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict = {}

# archs ported so far (the reference registers eleven)
PORTED = ["smollm_135m", "granite_moe_1b_a400m", "deepseek_v3_671b", "llama3_8b_proxy",
          "internlm2_1_8b", "mistral_large_123b", "nemotron_4_340b"]


def register(name: str, config: ArchConfig, smoke: ArchConfig) -> None:
    _REGISTRY[name] = (config, smoke)


def get(name: str, smoke: bool = False) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not yet ported (ported: {PORTED})")
    cfg, smk = _REGISTRY[name]
    return smk if smoke else cfg


def _load_all() -> None:
    import importlib
    for mod in PORTED:
        importlib.import_module(f"repro_torch.configs.{mod}")
