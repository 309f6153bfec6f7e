"""Granite-3.0-1B-A400M: 32-expert top-8 MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import (ArchConfig, LayerGroup, SALRModelConfig,
                                      register)

CONFIG = ArchConfig(
    name="granite_moe_1b_a400m", family="moe",
    d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, mlp="moe",
    layer_groups=(LayerGroup(("attn",), 24, mlp="moe"),),
    n_experts=32, experts_per_token=8, n_shared_experts=0, moe_d_ff=512,
)

SMOKE = ArchConfig(
    name="granite_moe_1b_a400m_smoke", family="moe",
    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=64, vocab_size=512, mlp="moe", dtype="float32",
    layer_groups=(LayerGroup(("attn",), 2, mlp="moe"),),
    n_experts=8, experts_per_token=2, n_shared_experts=0, moe_d_ff=64,
    salr=SALRModelConfig(lora_rank=4, res_rank=4, method="bitmap"),
)

register("granite_moe_1b_a400m", CONFIG, SMOKE)
