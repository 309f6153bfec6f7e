"""Low-rank adapters and the SALR multi-adapter concatenation scheme:
sum_i (x A_i) B_i == (x A_cat) B_cat with A_cat = [A_1 ... A_n] and
B_cat = [B_1; ...; B_n]."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class LoRAAdapter:
    """One low-rank pair.  Effective update = scale * (x @ a) @ b."""
    a: torch.Tensor          # (d_in, r)
    b: torch.Tensor          # (r, d_out)
    scale: float = 1.0

    def delta_w(self) -> torch.Tensor:
        return self.scale * (self.a @ self.b)


def init_lora(gen: torch.Generator, d_in: int, d_out: int, rank: int,
              alpha: Optional[float] = None, dtype=torch.float32,
              device="cpu") -> LoRAAdapter:
    """Standard LoRA init: A ~ N(0, 1/r), B = 0 (so delta starts at 0).
    ``gen`` is a CPU generator; the factors move to ``device``."""
    if alpha is None:
        alpha = float(rank)
    if rank == 0:  # degenerate adapter (SALR base-only configurations)
        return LoRAAdapter(a=torch.zeros((d_in, 0), dtype=dtype, device=device),
                           b=torch.zeros((0, d_out), dtype=dtype, device=device),
                           scale=1.0)
    a = torch.randn((d_in, rank), generator=gen) * (1.0 / math.sqrt(rank))
    return LoRAAdapter(a=a.to(device=device, dtype=dtype),
                       b=torch.zeros((rank, d_out), dtype=dtype, device=device),
                       scale=alpha / rank)
