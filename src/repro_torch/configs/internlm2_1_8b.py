"""InternLM2-1.8B (dense GQA). [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import (ArchConfig, LayerGroup, SALRModelConfig,
                                      register)

CONFIG = ArchConfig(
    name="internlm2_1_8b", family="dense",
    d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544, mlp="swiglu",
    layer_groups=(LayerGroup(("attn",), 24),),
)

SMOKE = ArchConfig(
    name="internlm2_1_8b_smoke", family="dense",
    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, mlp="swiglu", dtype="float32",
    layer_groups=(LayerGroup(("attn",), 2),),
    salr=SALRModelConfig(lora_rank=4, res_rank=4, method="bitmap"),
)

register("internlm2_1_8b", CONFIG, SMOKE)
