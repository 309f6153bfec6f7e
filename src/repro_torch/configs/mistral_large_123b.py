"""Mistral-Large-Instruct-2407 (123B dense).
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.configs.base import (ArchConfig, LayerGroup, SALRModelConfig,
                                      register)

CONFIG = ArchConfig(
    name="mistral_large_123b", family="dense",
    d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32768, mlp="swiglu", rope_theta=1e6,
    layer_groups=(LayerGroup(("attn",), 88),),
)

SMOKE = ArchConfig(
    name="mistral_large_123b_smoke", family="dense",
    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, mlp="swiglu", dtype="float32",
    layer_groups=(LayerGroup(("attn",), 2),),
    salr=SALRModelConfig(lora_rank=4, res_rank=4, method="bitmap"),
)

register("mistral_large_123b", CONFIG, SMOKE)
