"""NF4 levels, NF4 block quantization and the error budgets for parity
against the reference.

Copies of ``repro.core.quant.NF4_LEVELS`` and ``ERROR_BUDGETS`` (a CPU
test pins both equal).  Budgets are relative-L2 ceilings: ``method:*``
for a native route against its reference formulation, ``repr:*`` for a
quantized-base route against the native base, ``kv:*`` for decode over
a quantized KV cache against the native cache.

``quantize_nf4`` packs codes INTERLEAVED (byte i holds element 2i in its
low nibble and 2i+1 in its high nibble), unlike the KV caches' split
packing; with ``block = QBLOCK`` over a row-major (K, N) weight it gives
the layout ``ops.nf4_matmul`` reads.
"""
import dataclasses
import math

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

# scale-block width along N of the 2-D NF4 weight layout (ops.nf4_matmul)
QBLOCK = 64

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


@dataclasses.dataclass(frozen=True)
class NF4Tensor:
    """NF4-quantized tensor: 4-bit codes packed two per byte (interleaved)
    and one f32 absmax scale per ``block`` consecutive elements."""
    codes: torch.Tensor     # uint8 (n_elems_padded // 2,)
    scales: torch.Tensor    # f32 (n_blocks,)
    shape: tuple            # logical shape
    block: int


def quantize_nf4(x: torch.Tensor, block: int = 64) -> NF4Tensor:
    """Blockwise NF4 over the flattened ``x`` (zero-padded to a block
    multiple): per-block absmax scale, nearest level of each entry."""
    shape = tuple(x.shape)
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scales = blocks.abs().amax(dim=1).clamp(min=1e-12)
    idx = nf4_index(blocks / scales[:, None]).reshape(-1)
    codes = idx[0::2] | (idx[1::2] << 4)
    return NF4Tensor(codes=codes, scales=scales, shape=shape, block=block)


def dequantize_nf4(q: NF4Tensor, dtype=torch.float32) -> torch.Tensor:
    """Level x block scale in f32, then ``dtype``."""
    idx = torch.stack([q.codes & 0x0F, q.codes >> 4], dim=1).reshape(-1)
    vals = nf4_levels(q.codes.device)[idx.long()].reshape(-1, q.block) * q.scales[:, None]
    return vals.reshape(-1)[:math.prod(q.shape)].reshape(q.shape).to(dtype)


def nf4_dequant_2d(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The 2-D weight layout decoded: ([E,] K, N/2) interleaved codes and
    ([E,] K, N/block) scales -> ([E,] K, N) f32, each entry level x its
    block's scale (byte i of a row holds column 2i low, 2i+1 high)."""
    lead = codes.shape[:-1]
    idx = torch.stack([codes & 0x0F, codes >> 4], dim=-1).reshape(*lead, -1)
    vals = nf4_levels(codes.device)[idx.long()].reshape(*scales.shape, -1)
    return (vals * scales[..., None]).reshape(*lead, -1)
