"""NF4 levels and the error budgets for parity against the reference.

Copies of ``repro.core.quant.NF4_LEVELS`` and ``ERROR_BUDGETS`` (a CPU
test pins both equal).  Budgets are relative-L2 ceilings: ``method:*``
for a native route against its reference formulation, ``repr:*`` for a
quantized-base route against the native base, ``kv:*`` for decode over
a quantized KV cache against the native cache.
"""
import torch

# The 16 NF4 levels (QLoRA, Dettmers et al. 2023): quantiles of N(0, 1)
# normalized to [-1, 1], as float32.
NF4_LEVELS = torch.tensor([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], dtype=torch.float32)

ERROR_BUDGETS = {
    "method:dense": 1e-4,
    "method:mask": 1e-4,
    "method:bitmap": 1e-4,
    "method:nm": 1e-4,
    "method:bitmap_nf4": 1e-4,
    "repr:nf4": 0.15,
    "repr:bitmap_nf4": 0.15,
    "kv:int8": 0.05,
    "kv:nf4": 0.15,
}


def error_budget(kind: str, name: str) -> float:
    """Budget lookup (``kind`` in {method, repr, kv}); native routes share
    the method floor."""
    if name == "native":
        return ERROR_BUDGETS["method:dense"]
    return ERROR_BUDGETS[f"{kind}:{name}"]


def has_budget(kind: str, name: str) -> bool:
    """Whether ``error_budget(kind, name)`` resolves."""
    return name == "native" or f"{kind}:{name}" in ERROR_BUDGETS


def nf4_levels(device) -> torch.Tensor:
    return NF4_LEVELS.to(device)


def nf4_index(normed: torch.Tensor) -> torch.Tensor:
    """Nearest NF4 level of each f32 entry as uint8; a tie goes to the
    lower index (torch.argmin and jnp.argmin both return the first)."""
    dist = (normed[..., None] - nf4_levels(normed.device)).abs()
    return dist.argmin(dim=-1).to(torch.uint8)
