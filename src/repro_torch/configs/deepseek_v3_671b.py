"""DeepSeek-V3-671B: MLA + 1 shared / 256 routed top-8 MoE, 3 leading
dense layers. [arXiv:2412.19437; hf]"""
from repro_torch.configs.base import (ArchConfig, LayerGroup, MLAConfig, SALRModelConfig,
                                      register)

CONFIG = ArchConfig(
    name="deepseek_v3_671b", family="moe",
    d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab_size=129280, mlp="swiglu",
    layer_groups=(LayerGroup(("mla",), 3, mlp="swiglu"),
                  LayerGroup(("mla",), 58, mlp="moe")),
    n_experts=256, experts_per_token=8, n_shared_experts=1, moe_d_ff=2048,
    first_dense_layers=3,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
)

SMOKE = ArchConfig(
    name="deepseek_v3_671b_smoke", family="moe",
    d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512, mlp="swiglu", dtype="float32",
    layer_groups=(LayerGroup(("mla",), 1, mlp="swiglu"),
                  LayerGroup(("mla",), 2, mlp="moe")),
    n_experts=8, experts_per_token=2, n_shared_experts=1, moe_d_ff=64,
    first_dense_layers=1,
    mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
    salr=SALRModelConfig(lora_rank=4, res_rank=4, method="bitmap"),
)

register("deepseek_v3_671b", CONFIG, SMOKE)
