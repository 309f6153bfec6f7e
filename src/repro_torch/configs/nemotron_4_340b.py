"""Nemotron-4-340B (dense GQA, squared-ReLU). [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import (ArchConfig, LayerGroup, SALRModelConfig,
                                      register)

CONFIG = ArchConfig(
    name="nemotron_4_340b", family="dense",
    d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000, mlp="relu2",
    layer_groups=(LayerGroup(("attn",), 96),),
)

SMOKE = ArchConfig(
    name="nemotron_4_340b_smoke", family="dense",
    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512, mlp="relu2", dtype="float32",
    layer_groups=(LayerGroup(("attn",), 2),),
    salr=SALRModelConfig(lora_rank=4, res_rank=4, method="bitmap"),
)

register("nemotron_4_340b", CONFIG, SMOKE)
