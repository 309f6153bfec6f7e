"""Sparsity-preservation residual: truncated-SVD low-rank recovery of the
pruned-away entries (paper, Theorem 3)."""
from __future__ import annotations

import torch

from repro_torch.core.adapters import LoRAAdapter


def truncated_svd_adapter(e: torch.Tensor, rank: int, dtype=None) -> LoRAAdapter:
    """Best rank-r approximation of the residual E as a LoRA pair,
    balanced: E ~= (U_r sqrt(S_r)) (sqrt(S_r) V_r^T).  The SVD runs in f32;
    leading axes of E (an expert stack) are decomposed as one batch."""
    if dtype is None:
        dtype = e.dtype
    u, s, vt = torch.linalg.svd(e.to(torch.float32), full_matrices=False)
    r = min(rank, s.shape[-1])
    sq = torch.sqrt(s[..., :r])
    a = (u[..., :, :r] * sq[..., None, :]).to(dtype)
    b = (sq[..., :, None] * vt[..., :r, :]).to(dtype)
    if r < rank:  # pad to the requested static rank with zeros
        a = torch.nn.functional.pad(a, (0, rank - r))
        b = torch.nn.functional.pad(b, (0, 0, 0, rank - r))
    return LoRAAdapter(a=a, b=b, scale=1.0)
