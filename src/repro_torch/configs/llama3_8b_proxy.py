"""Llama-3-8B (the paper's main fine-tuning target; Tables 2-5,7, Fig 3).
[arXiv:2407.21783; hf]"""
from repro_torch.configs.base import (ArchConfig, LayerGroup, SALRModelConfig,
                                      register)

CONFIG = ArchConfig(
    name="llama3_8b_proxy", family="dense",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, mlp="swiglu", rope_theta=5e5,
    layer_groups=(LayerGroup(("attn",), 32),),
)

SMOKE = ArchConfig(
    name="llama3_8b_proxy_smoke", family="dense",
    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, mlp="swiglu", dtype="float32",
    layer_groups=(LayerGroup(("attn",), 2),),
    salr=SALRModelConfig(lora_rank=4, res_rank=4, method="bitmap"),
)

register("llama3_8b_proxy", CONFIG, SMOKE)
