"""SmolLM-135M (llama-arch small). [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import (ArchConfig, LayerGroup, SALRModelConfig,
                                      register)

CONFIG = ArchConfig(
    name="smollm_135m", family="dense",
    d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab_size=49152, mlp="swiglu",
    layer_groups=(LayerGroup(("attn",), 30),),
)

SMOKE = ArchConfig(
    name="smollm_135m_smoke", family="dense",
    d_model=96, n_heads=3, n_kv_heads=1, head_dim=32,
    d_ff=192, vocab_size=512, mlp="swiglu", dtype="float32",
    layer_groups=(LayerGroup(("attn",), 2),),
    salr=SALRModelConfig(lora_rank=4, res_rank=4, method="bitmap"),
)

register("smollm_135m", CONFIG, SMOKE)
